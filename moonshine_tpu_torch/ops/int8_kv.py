"""Int8 KV caches with dequantization folded into the attention products.

Counterpart of the JAX package's ``ops/int8_kv.py``.  One symmetric scale
per key column (per cached time position, amax over head_dim) commutes
past both attention contractions:

  K:  logits[s,t] = (sum_d q[s,d] * k_q[d,t]) * ks[t]
  V:  out[s,d]    = sum_t (w[s,t] * vs[t]) * v_q[d,t]

Cache layout is dim-major ``[.., hd, T]`` with scales ``[.., T]``.

This module owns the decoders' KV-cache format: a layer's caches travel
as one :class:`LayerKV`, :func:`write_kv` stores new keys and values in
them (quantized where the caches are int8) and :func:`attend_kv` attends
over them (``attention_dm_q8`` over int8 caches, :func:`attention_dm`
over float ones).  No decoder branches on the format.

``attention_dm_q8`` on CUDA tensors launches K5 (``csrc/int8_attention.cu``),
which reads the int8 caches and their scales in place and folds the
dequantization into its own products: no float copy of the cache is
formed.  It counts each launch in the recorder's ``launches.int8_attention``
(:data:`Q8_LAUNCHES`).  On CPU tensors it runs the plain einsums below,
which do form a float copy of the cache (``k_q.float()``,
``v_q.to(q.dtype)``), and which K5 follows rounding place by rounding
place.  Neither falls back to the other.  ``attention_dm_q8_with_weights``
(word timestamps) is plain on every device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from .. import profiling
from . import _build

NEG_INF = -1e9
Q8_LAUNCHES = "launches.int8_attention"  # the recorder's count of K5 launches
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_PER_BLOCK = 232_448  # shared memory one Hopper block may opt into
_WARPS = 8  # the kernel's 256 threads


class LayerKV(NamedTuple):
    """One layer's dim-major caches [.., hd, T]; the scales [.., T] are
    set where the caches are int8, None where they are float."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def layer_kv(caches, kind: str, layer: int) -> LayerKV:
    """Layer ``layer`` of the ``kind`` ("self" or "cross") caches of a
    ``DecoderCache`` or a ``BatchedStreamingState``: the fields
    ``k_<kind>``, ``v_<kind>``, ``k_<kind>_scale`` and ``v_<kind>_scale``."""
    return LayerKV(*(None if x is None else x[layer]
                     for x in (getattr(caches, f"{n}_{kind}{s}") for s in ("", "_scale")
                               for n in "kv")))


def write_kv(kv: LayerKV, k_new: torch.Tensor, v_new: torch.Tensor,
             put: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> LayerKV:
    """Store a layer's new dim-major K and V [.., hd, s] in its caches:
    int8 caches take ``quantize_kv``'s values and scales (K and V
    quantized, then K, V, K's scales and V's written), float caches the
    values in their dtype.  ``put(buf, new)`` writes ``new`` into the last
    axis of ``buf`` at the caller's columns and returns the buffer written
    (a copy where the caller's rule makes one).  Returns the caches
    written."""
    if kv.k_scale is None:
        return kv._replace(k=put(kv.k, k_new.to(kv.k.dtype)), v=put(kv.v, v_new.to(kv.v.dtype)))
    (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
    return LayerKV(put(kv.k, kq), put(kv.v, vq), put(kv.k_scale, ks), put(kv.v_scale, vs))


def attend_kv(q: torch.Tensor, kv: LayerKV, mask: torch.Tensor | None,
              with_weights: bool = False):
    """Attention of q [B, s, H, hd] over a layer's caches [B, H, hd, T]:
    ``attention_dm_q8`` over int8 caches, :func:`attention_dm` over float
    caches read in q's dtype.  With ``with_weights`` also returns the
    float32 softmax weights [B, H, s, T]."""
    if kv.k_scale is None:
        return attention_dm(q, kv.k.to(q.dtype), kv.v.to(q.dtype), mask, with_weights)
    args = (q, kv.k, kv.k_scale, kv.v, kv.v_scale, mask)
    return attention_dm_q8_with_weights(*args) if with_weights else attention_dm_q8(*args)


def attention_dm(q, k, v, mask, with_weights: bool = False):
    """Attention over float dim-major K/V [B, H, hd, T]; with
    ``with_weights`` also returns the float32 softmax weights [B, H, s, T]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bhdt->bhst", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhdt->bshd", weights.to(q.dtype), v)
    return (out, weights) if with_weights else out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-key-column symmetric int8 quantization.

    x: [..., hd, t] (dim-major) -> (q int8 [..., hd, t], scale f32 [..., t])
    with scale = amax over hd / 127 (1.0 where the column is all zero).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, :]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rebuild a float cache (a testing aid; attention never forms it)."""
    return (q.float() * scale[..., None, :]).to(dtype)


def _logits_q8(q, k_q, k_s, mask):
    # int8 and bf16 values are exact in float32, so a float32 product is
    # the JAX "operands in q.dtype, float32 accumulation" contraction.
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bhdt->bhst", q.float(), k_q.float())
    logits = logits * (k_s * scale)[:, :, None, :]
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return torch.softmax(logits, dim=-1)


def max_columns(head_dim: int) -> int:
    """The longest cache (T columns) K5 takes at ``head_dim``: one query
    row's float32 logits over every column, rounded up to 16, beside q's
    row and the reductions, within one block's shared memory (the same
    arithmetic as ``csrc/int8_attention.cu``'s ``smem_bytes`` at R=1)."""
    return (_SMEM_PER_BLOCK // 4 - head_dim - _WARPS - 2) // 16 * 16


def _broadcasts(shape, target) -> bool:
    """Whether ``shape`` broadcasts to ``target`` (``torch.broadcast_shapes``
    costs about a hundred microseconds of host time a call)."""
    return len(shape) <= len(target) and all(
        m == 1 or m == n for m, n in zip(reversed(shape), reversed(target)))


def _mask_strides(mask, target) -> tuple:
    """The element strides of ``mask`` broadcast to ``target`` (4-D): 0 where
    it broadcasts."""
    pad = len(target) - mask.dim()
    return tuple(0 if i < pad or (mask.shape[i - pad] == 1 and n != 1) else mask.stride(i - pad)
                 for i, n in enumerate(target))


def _check(q, k_q, k_s, v_q, v_s, mask) -> None:
    """Shapes, dtypes and devices, on every device."""
    if q.dim() != 4 or k_q.dim() != 4:
        raise ValueError(f"q must be [B, s, H, hd] and k_q [B, H, hd, T]; got "
                         f"{tuple(q.shape)} and {tuple(k_q.shape)}")
    b, s, h, hd = q.shape
    t = k_q.shape[3]
    if tuple(k_q.shape) != (b, h, hd, t) or v_q.shape != k_q.shape:
        raise ValueError(f"k_q and v_q must be [B, H, hd, T] = [{b}, {h}, {hd}, T]; got "
                         f"{tuple(k_q.shape)} and {tuple(v_q.shape)}")
    if tuple(k_s.shape) != (b, h, t) or v_s.shape != k_s.shape:
        raise ValueError(f"k_s and v_s must be [B, H, T] = {(b, h, t)}; got "
                         f"{tuple(k_s.shape)} and {tuple(v_s.shape)}")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError(f"k_q and v_q must be int8; got {k_q.dtype} and {v_q.dtype}")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError(f"k_s and v_s must be float32; got {k_s.dtype} and {v_s.dtype}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"q must be a float tensor; got {q.dtype}")
    tensors = [q, k_q, k_s, v_q, v_s]
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError(f"mask must be bool; got {mask.dtype}")
        if not _broadcasts(mask.shape, (b, h, s, t)):
            raise ValueError(f"mask {tuple(mask.shape)} does not broadcast to [B, H, s, T] = "
                             f"{(b, h, s, t)}")
        tensors.append(mask)
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, the caches, their scales and the mask must lie on one device")


@functools.cache
def _kernel():
    """K5's C entry point, built at first use, with its signature declared
    (without ``argtypes`` ctypes would pass each pointer as a 32-bit int)."""
    fn = _build.load("int8_attention").int8_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_q, k_s, v_q, v_s, mask) -> torch.Tensor:
    """Check what K5 takes, launch it on q's stream, raise on a launch
    error; returns [B, s, H, hd] in q's dtype.  Reads every operand in
    place through its strides."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_dm_q8: the kernel takes q in {list(_DTYPE_CODES)}; got "
                        f"{q.dtype}")
    if torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError("attention_dm_q8: the kernel has no backward, and q requires grad")
    b, s, h, hd = q.shape
    t = k_q.shape[3]
    if hd > MAX_HEAD_DIM or t > max_columns(hd):
        raise ValueError(f"attention_dm_q8: the kernel takes head_dim <= {MAX_HEAD_DIM} and T "
                         f"<= {max_columns(min(hd, MAX_HEAD_DIM))}; got {hd} and {t}")
    if any(x.stride(-1) != 1 for x in (k_q, v_q, k_s, v_s)):
        raise ValueError("attention_dm_q8: the caches and scales must have T stride 1")
    if q.device.type != "cuda":
        raise ValueError(f"attention_dm_q8: no kernel for device {q.device}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if t == 0:
        raise ValueError("attention_dm_q8: the kernel takes T >= 1")
    m_strides = (0, 0, 0, 0) if mask is None else _mask_strides(mask, (b, h, s, t))
    strides = (*q.stride(), *k_q.stride()[:3], *k_s.stride()[:2], *v_q.stride()[:3],
               *v_s.stride()[:2], *m_strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
                       v_s.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                       (ctypes.c_longlong * 5)(b, h, s, t, hd),
                       (ctypes.c_longlong * 18)(*strides), _DTYPE_CODES[q.dtype],
                       float(hd) ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"attention_dm_q8 launch failed with CUDA error {rc} (B={b}, s={s}, "
                           f"H={h}, hd={hd}, T={t}, {q.dtype})")
    profiling.count(Q8_LAUNCHES)
    return out


def attention_dm_q8(
    q: torch.Tensor,    # [B, s, H, hd] float
    k_q: torch.Tensor,  # [B, H, hd, T] int8
    k_s: torch.Tensor,  # [B, H, T] f32
    v_q: torch.Tensor,  # [B, H, hd, T] int8
    v_s: torch.Tensor,  # [B, H, T] f32
    mask: torch.Tensor | None,  # bool, broadcastable to [B, H, s, T]
) -> torch.Tensor:
    """Attention over dim-major int8 K/V with folded dequantization:
    the plain einsums on CPU tensors, K5 on CUDA tensors (see the module
    docstring)."""
    _check(q, k_q, k_s, v_q, v_s, mask)
    if q.device.type == "cpu":
        return attention_dm_q8_with_weights(q, k_q, k_s, v_q, v_s, mask)[0]
    return _launch(q, k_q, k_s, v_q, v_s, mask)


def attention_dm_q8_with_weights(q, k_q, k_s, v_q, v_s, mask):
    """``attention_dm_q8`` that also returns the softmax weights
    [B, H, s, T] (float32)."""
    weights = _logits_q8(q, k_q, k_s, mask)
    wv = (weights * v_s[:, :, None, :]).to(q.dtype)
    out = torch.einsum("bhst,bhdt->bshd", wv, v_q.to(q.dtype))
    return out, weights
