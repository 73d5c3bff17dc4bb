"""Checkpoints of the parameters and of the train state.

Counterpart of the JAX package's ``train/checkpoint.py``:

- ``export_safetensors`` / ``import_safetensors`` write and read the JAX
  package's names and layouts (``/``-joined tree paths, layers stacked on
  a leading axis, dense kernels ``[in, out]``), so that a file written by
  either package loads in the other.  The encoder's pair-swapped rotary
  copies are not written (they are derived from q and k, and JAX's
  training tree has none); ``import_safetensors`` rebuilds them.
- ``save_checkpoint`` / ``restore_checkpoint`` keep a ``TrainState``.  The
  JAX package writes it with Orbax, which the port does not have; the
  port writes one safetensors file of its own: every parameter under
  ``params/<name>``, each optimizer moment under ``opt/<name>/<key>`` and
  the step count in the header's metadata.  Restoring gives the exact
  next step.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from ..core.config import MoonshineArchConfig
from ..models import moonshine as mm
from ..weights import (
    flatten_tree,
    load_safetensors,
    load_safetensors_with_metadata,
    params_from_jax_numpy,
    params_to_numpy,
    save_safetensors,
    unflatten_tree,
)
from .step import DERIVED, TrainState, optimizer_like, trainable_parameters


def _jax_flat(model: mm.Moonshine) -> dict[str, np.ndarray]:
    return {k: v for k, v in flatten_tree(params_to_numpy(model)).items()
            if not any(d in k.split("/") for d in DERIVED)}


def export_safetensors(path: str | Path, model: mm.Moonshine) -> None:
    """``model``'s parameters as a safetensors file in the JAX package's
    names and layouts (float32; bf16 weights are exact in it)."""
    save_safetensors(path, _jax_flat(model))


def import_safetensors(path: str | Path, target: mm.Moonshine,
                       cfg: MoonshineArchConfig) -> mm.Moonshine:
    """A file saved by ``export_safetensors`` (either package's) as a new
    model shaped like ``target``, in its dtype and on its device.  Raises
    ``KeyError`` for a tensor the file lacks and ``ValueError`` for one of
    another shape, as JAX's does.  ``cfg`` is the target's architecture
    (the layer counts and the rotary copies)."""
    flat = load_safetensors(path)
    loaded = {}
    for name, leaf in _jax_flat(target).items():
        if name not in flat:
            raise KeyError(f"Checkpoint missing tensor {name!r}")
        arr = flat[name]
        if arr.shape != leaf.shape:
            raise ValueError(f"Shape mismatch for {name}: {arr.shape} vs {leaf.shape}")
        loaded[name] = arr
    embed = target.decoder.embed
    model = params_from_jax_numpy(unflatten_tree(loaded), cfg, embed.device)
    return model.to(embed.dtype)


def _opt_key(name: str, key: str) -> str:
    return f"opt/{name}/{key}"


def save_checkpoint(path: str | Path, state: TrainState) -> None:
    """``state``'s parameters, optimizer moments and step count as one
    safetensors file (port names and layouts)."""
    model, opt = state.params, state.opt_state
    tensors = {f"params/{n}": p.detach().cpu().numpy() for n, p in model.named_parameters()}
    for name, p in trainable_parameters(model):
        for key, value in opt.state.get(p, {}).items():
            tensors[_opt_key(name, key)] = torch.as_tensor(value).detach().cpu().numpy()
    save_safetensors(path, tensors, {"step": str(state.step),
                                     "optimizer": type(opt).__name__})


def restore_checkpoint(path: str | Path, target: TrainState) -> TrainState:
    """A new TrainState shaped like ``target`` (its model, optimizer kind
    and settings, device) with the saved values."""
    flat, meta = load_safetensors_with_metadata(path)
    model = copy.deepcopy(target.params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = flat.get(f"params/{name}")
            if arr is None:
                raise KeyError(f"Checkpoint missing tensor {'params/' + name!r}")
            if arr.shape != tuple(p.shape):
                raise ValueError(f"Shape mismatch for {name}: {arr.shape} vs {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.copy()))
    opt = target.opt_state
    params = [p for _, p in trainable_parameters(model)]
    new = optimizer_like(opt, params)
    for name, p in trainable_parameters(model):
        prefix = f"opt/{name}/"
        saved = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        if saved:
            new.state[p] = {k: torch.from_numpy(v.copy()).to(
                p.device if v.ndim else "cpu") for k, v in saved.items()}
    return TrainState(model, new, int(meta["step"]))
