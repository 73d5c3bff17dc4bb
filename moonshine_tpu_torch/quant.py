"""Per-channel int8 weight quantization, in PyTorch and numpy.

Counterpart of the JAX package's ``quant.py`` (the reference's post-training
quantization: per-channel int8, the frontend kept float).

- ``quantize_tree``, ``dequantize_tree`` and ``fake_quantize_tree`` work on
  numpy parameter trees in the JAX package's layout (``weights.
  params_to_numpy`` gives one; ``weights.params_from_jax_numpy`` takes a
  float result back), with the JAX package's arithmetic: storage int8 with
  per-output-channel scales, its inverse, and quantize-then-dequantize.
- ``quantize_tree_exec`` takes a port model (``models.moonshine.Moonshine``
  or ``models.streaming.StreamingMoonshine``) and returns a copy whose dense
  layers hold int8 ``w_q`` and float32 ``w_scale`` (one scale per output
  channel, reduced over the contraction axis only), which ``layers.dense``
  runs as w8a8: dynamic int8 activations x int8 weights -> int32.  The
  weights are quantized in numpy, as the JAX package does, so the two give
  the same bits.

Norm scales, biases and the decoder ``embed`` stay float in the exec form;
the frontend subtree stays float in every form.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .models.layers import Dense

Params = Any

# Keys whose arrays are quantized (2-D+ weights); everything else is kept.
_WEIGHT_KEY = "w"
_EMBED_KEY = "embed"


def _quantize_array(w: np.ndarray, axis: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization along ``axis`` (out-channel)."""
    w = np.asarray(w, np.float32)
    move = np.moveaxis(w, axis, -1)
    amax = np.max(np.abs(move), axis=tuple(range(move.ndim - 1)))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(move / scale), -127, 127).astype(np.int8)
    return np.moveaxis(q, -1, axis), scale


def _dequantize_array(q: np.ndarray, scale: np.ndarray, axis: int = -1) -> np.ndarray:
    move = np.moveaxis(np.asarray(q, np.float32), axis, -1)
    return np.moveaxis(move * scale, -1, axis)


def _walk_weights(params: Params, skip_subtrees: tuple[str, ...], on_weight, on_embed):
    """Rebuild a tree, replacing each 2-D+ ``w`` leaf's entries by
    ``on_weight(key, value)`` and the 2-D ``embed`` by ``on_embed``; a
    top-level subtree named in ``skip_subtrees`` is kept as it is."""

    def walk(node, top: bool):
        if isinstance(node, Mapping):
            out = {}
            for k, v in node.items():
                if k in skip_subtrees and top:
                    out[k] = v
                elif k == _WEIGHT_KEY and hasattr(v, "ndim") and v.ndim >= 2:
                    out.update(on_weight(k, v))
                elif k == _EMBED_KEY and on_embed and hasattr(v, "ndim") and v.ndim == 2:
                    out.update(on_embed(k, v))
                else:
                    out[k] = walk(v, False)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, False) for v in node)
        return node

    return walk(params, True)


def quantize_tree(params: Params, skip_subtrees: tuple[str, ...] = ("frontend",)) -> Params:
    """Numpy parameter tree -> the same structure with int8 weights.

    Dense/conv ``{"w": [..., out]}`` leaves become ``{"w_q": int8,
    "w_scale": [out]}``; the decoder ``embed`` table ([vocab, d], rows are
    channels) becomes ``embed_q``/``embed_scale``.
    """

    def weight(_, v):
        q, s = _quantize_array(np.asarray(v), axis=-1)
        return {"w_q": q, "w_scale": s}

    def embed(_, v):
        q, s = _quantize_array(np.asarray(v), axis=0)  # per row
        return {"embed_q": q, "embed_scale": s}

    return _walk_weights(params, skip_subtrees, weight, embed)


def dequantize_tree(params_q: Params, dtype=np.float32) -> Params:
    """Inverse of ``quantize_tree``: float numpy parameters again."""

    def walk(node):
        if isinstance(node, Mapping):
            out = {}
            for k, v in node.items():
                if k in ("w_scale", "embed_scale"):
                    continue
                if k == "w_q":
                    out[_WEIGHT_KEY] = np.asarray(
                        _dequantize_array(v, np.asarray(node["w_scale"]), -1), dtype)
                elif k == "embed_q":
                    out[_EMBED_KEY] = np.asarray(
                        _dequantize_array(v, np.asarray(node["embed_scale"]), 0), dtype)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params_q)


def fake_quantize_tree(params: Params, skip_subtrees: tuple[str, ...] = ("frontend",),
                       per_channel: bool = True, dtype=np.float32) -> Params:
    """Quantize then dequantize: float parameters that carry the int8
    weights' exact values.  ``per_channel=False`` uses one scale per
    tensor."""

    def fq(w, axis):
        w_np = np.asarray(w)
        if per_channel:
            q, s = _quantize_array(w_np, axis)
            return np.asarray(_dequantize_array(q, s, axis), dtype)
        amax = float(np.max(np.abs(w_np)))
        scale = amax / 127.0 if amax > 0 else 1.0
        q = np.clip(np.round(w_np / scale), -127, 127)
        return np.asarray(q * scale, dtype)

    return _walk_weights(params, skip_subtrees, lambda k, v: {k: fq(v, -1)},
                         lambda k, v: {k: fq(v, 0)})


def _exec_quantized(p: Dense) -> Dense:
    """A float dense layer -> its w8a8 form.  The port keeps ``[out, in]``;
    the scale reduces over ``in``, as the JAX package's over its ``[in,
    out]`` axis -2, with the same numpy arithmetic."""
    w = p.weight.detach().float().cpu().numpy()
    amax = np.max(np.abs(w), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    dev = p.weight.device
    return Dense(None, p.bias, w_q=torch.from_numpy(q).to(dev),
                 w_scale=torch.from_numpy(scale).to(dev))


def quantize_tree_exec(model: nn.Module,
                       skip_subtrees: tuple[str, ...] = ("frontend",)) -> nn.Module:
    """A port model -> a copy whose dense layers run w8a8 (``layers.dense``).

    Every ``Dense`` outside the top-level subtrees named in
    ``skip_subtrees`` becomes ``w_q`` int8 ``[out, in]`` + ``w_scale``
    float32 ``[out]`` on the layer's device; the encoder's pair-swapped
    rotary projections are quantized like the rest (a permutation of
    output channels, so the same values).  ``embed`` stays float.
    """
    model = copy.deepcopy(model)

    def walk(module: nn.Module, top: bool) -> None:
        for name, child in list(module.named_children()):
            if top and name in skip_subtrees:
                continue
            if isinstance(child, Dense):
                if not child.quantized:
                    setattr(module, name, _exec_quantized(child))
            else:
                walk(child, False)

    walk(model, True)
    return model


def weight_of(p: Dense, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The float weight ``[out, in]`` of a dense layer, whether it holds
    ``weight`` or exec-quantized ``w_q``/``w_scale`` (for a caller that
    contracts the weight in its own product, as ``compute_cross_kv``
    does)."""
    if not p.quantized:
        return p.weight.to(dtype)
    return p.w_q.to(dtype) * p.w_scale.to(dtype)[:, None]


def tree_nbytes(params: Params) -> int:
    """Bytes of a numpy parameter tree."""
    if isinstance(params, Mapping):
        return sum(tree_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_nbytes(v) for v in params)
    return np.asarray(params).nbytes
