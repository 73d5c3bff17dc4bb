"""Pieces the drivers share: building the program's model from the
benchmark's weights, synchronising, and the precision a cell states."""

from __future__ import annotations

import time

import torch

from ..weights import load_into, make_weights, served


def now() -> float:
    return time.perf_counter()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tuples(arch: dict) -> dict:
    """A configuration's fields with its lists as tuples (the port's
    config dataclasses hold tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()}


def dtype_of(precision: dict) -> torch.dtype:
    return torch.bfloat16 if precision["weights"] == "bfloat16" else torch.float32


def meta_model(init_params, cfg):
    """The program's model for ``cfg`` with no storage: its leaves' names
    and shapes, and a frame to copy weights into."""
    with torch.device("meta"):
        return init_params(cfg, torch.Generator(), device="meta")


def benchmark_weights(shapes: dict, seed: int, device, bf16_prefixes: tuple[str, ...]) -> dict:
    """The benchmark's weights for the leaves ``shapes`` (``weights.leaf_
    shapes``), from ``seed``, with the leaves under ``bf16_prefixes`` at
    bfloat16 values."""
    w = make_weights(shapes, seed, device)
    return served(w, bf16_prefixes) if bf16_prefixes else w


def program_model(model_meta, weights: dict, device):
    """``model_meta`` given storage on ``device`` and ``weights``' values."""
    model = model_meta.to_empty(device=device)
    load_into(model, weights)
    return model
