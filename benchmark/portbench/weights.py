"""Random weights from the run's seed, made on the device.

The benchmark makes the weights and hands the same values to the program
and to the plain reference.  All draws come from one generator on the
device in two calls (one uniform buffer, one normal buffer for the
embedding), then each leaf takes its slice:

- a weight of two or more axes: uniform in +-1/sqrt(fan_in), fan_in the
  product of its axes after the first (the port's initializers' law);
- a norm's scale: 1 + U(-0.1, 0.1);
- a bias: U(-0.02, 0.02);
- ``decoder.embed``: N(0, 0.02^2).

``served`` rounds every leaf that the cell serves in bfloat16 to a
bfloat16 value (kept in float32 here), so that both sides see one set of
numbers.
"""

from __future__ import annotations

import math

import torch

from .traffic import device_generator

EMBED = "decoder.embed"


def leaf_shapes(model: torch.nn.Module) -> dict[str, tuple]:
    """Name and shape of every leaf the benchmark draws: the model's
    state-dict entries, without the copies the program derives itself
    (the encoder's pair-swapped rotary projections)."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items() if "_swapped." not in k}


def _is_norm(name: str, shape: tuple) -> bool:
    return len(shape) == 1 and not name.endswith(".bias")


@torch.no_grad()
def make_weights(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """float32 leaves on ``device`` drawn from ``seed``."""
    g = device_generator(seed, 0, device)
    sizes = {k: math.prod(s) for k, s in shapes.items() if k != EMBED}
    flat = torch.empty(sum(sizes.values()), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=g)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name == EMBED:
            continue
        u = flat[at:at + sizes[name]].view(shape)
        at += sizes[name]
        if name.endswith(".bias"):
            out[name] = u * 0.02
        elif _is_norm(name, shape):
            out[name] = 1.0 + 0.1 * u
        else:
            out[name] = u * (1.0 / math.prod(shape[1:])) ** 0.5
    if EMBED in shapes:
        emb = torch.empty(shapes[EMBED], dtype=torch.float32, device=device)
        out[EMBED] = emb.normal_(0.0, 0.02, generator=g)
    return out


def served(weights: dict[str, torch.Tensor], bf16_prefixes: tuple[str, ...]) -> dict:
    """The leaves under ``bf16_prefixes`` rounded to bfloat16 values."""
    return {k: v.to(torch.bfloat16).float() if k.startswith(bf16_prefixes) else v
            for k, v in weights.items()}


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s leaves of the same names (each
    cast to the leaf's dtype)."""
    params = dict(model.named_parameters())
    for name, value in weights.items():
        params[name].copy_(value)
