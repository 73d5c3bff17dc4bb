"""Int8 KV caches with dequantization folded into the attention products.

Counterpart of the JAX package's ``ops/int8_kv.py``.  One symmetric scale
per key column (per cached time position, amax over head_dim) commutes
past both attention contractions:

  K:  logits[s,t] = (sum_d q[s,d] * k_q[d,t]) * ks[t]
  V:  out[s,d]    = sum_t (w[s,t] * vs[t]) * v_q[d,t]

Cache layout is dim-major ``[.., hd, T]`` with scales ``[.., T]``.  The
caches may hold fewer heads than q (grouped-query attention): with H_kv
cache heads dividing q's H, q head h reads cache head h // (H / H_kv), in
place on every path (K5 indexes it; the plain versions group q's heads).

This module owns the decoders' KV-cache format: a layer's caches travel
as one :class:`LayerKV`, :func:`write_kv` stores new keys and values in
them (quantized where the caches are int8) at the columns of a rule this
module also owns (:class:`Cursor`, one host start for every row;
:class:`RowStarts`, a device start per row), and :func:`attend_kv`
attends over them (``attention_dm_q8`` over int8 caches,
:func:`attention_dm` over float ones).  No decoder branches on the format.

``write_kv`` into int8 caches on CUDA tensors launches K7
(``csrc/kv_write.cu``): ``quantize_kv`` of K and of V and the four writes
in one launch a layer, reading the new K/V and the per-row starts in place.
It counts each launch in the recorder's ``launches.kv_write``
(:data:`KV_WRITE_LAUNCHES`).  On CPU tensors it runs ``quantize_kv`` and
the rule's writes; K7 gives the same values and scales as that chain on
the card, bit for bit.

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
KV_WRITE_LAUNCHES = "launches.kv_write"  # the recorder's count of K7 launches
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_PER_BLOCK = 232_448  # shared memory one Hopper block may opt into
_WARPS = 8  # the kernel's 256 threads
MAX_WRITE_HEAD_DIM = 256  # the widest column K7 takes (csrc/kv_write.cu's kMaxHeadDim)
_WRITE_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_START_DTYPE_CODES = {torch.int32: 1, torch.int64: 2}  # 0: the host cursor


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


class Cursor(NamedTuple):
    """``write_kv``'s column rule at a host cursor: columns [start, start + s)
    of every row (the offline decoders' ``cur_len``)."""
    start: int

    def __call__(self, buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        """``new`` written into the last axis of ``buf`` at ``start``: in
        place, or, where autograd records ``new``, into a copy (the layers'
        caches are views of one tensor, so an in-place write would change
        what an earlier layer saved for its backward)."""
        end = self.start + new.shape[-1]
        if torch.is_grad_enabled() and new.requires_grad:
            return torch.slice_scatter(buf, new, dim=-1, start=self.start, end=end)
        buf[..., self.start:end] = new
        return buf


class RowStarts(NamedTuple):
    """``write_kv``'s column rule at per-row starts: row b's columns from
    ``start[b]`` (an int32 or int64 [B] tensor on the caches' device),
    clamped to [0, T - s] as XLA clamps a dynamic update slice's start (the
    streaming service's cursors)."""
    start: torch.Tensor

    def __call__(self, buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        """``new`` scattered into the last axis of ``buf`` [B, .., T] in
        place, at each row's columns; returns ``buf``."""
        s = new.shape[-1]
        cols = self.start.long().clamp(0, buf.shape[-1] - s)[:, None] + torch.arange(
            s, device=buf.device)  # [B, s]
        cols = cols.reshape(cols.shape[:1] + (1,) * (buf.dim() - 2) + cols.shape[1:])
        return buf.scatter_(-1, cols.expand(new.shape), new.to(buf.dtype))


def write_kv(kv: LayerKV, k_new: torch.Tensor, v_new: torch.Tensor,
             cols: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> LayerKV:
    """Store a layer's new dim-major K and V [.., hd, s] in its caches at
    the columns of ``cols``: int8 caches take ``quantize_kv``'s values and
    scales, through a :class:`Cursor` or a :class:`RowStarts` (K7 on CUDA
    tensors; on CPU tensors K and V quantized, then K, V, K's scales and V's
    written); float caches take the values in their dtype, through any
    ``cols(buf, new)`` that writes ``new`` into the last axis of ``buf`` and
    returns the buffer written (a copy where the rule makes one).  Returns
    the caches written."""
    if kv.k_scale is None:
        return kv._replace(k=cols(kv.k, k_new.to(kv.k.dtype)), v=cols(kv.v, v_new.to(kv.v.dtype)))
    if not isinstance(cols, (Cursor, RowStarts)):
        raise TypeError(f"write_kv: int8 caches take a Cursor or RowStarts column rule; got "
                        f"{type(cols).__name__}")
    if k_new.device.type != "cpu":
        _launch_write(kv, k_new, v_new, cols)
        return kv
    (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
    return LayerKV(cols(kv.k, kq), cols(kv.v, vq), cols(kv.k_scale, ks), cols(kv.v_scale, vs))


def attend_kv(q: torch.Tensor, kv: LayerKV, mask: torch.Tensor | None,
              with_weights: bool = False):
    """Attention of q [B, s, H, hd] over a layer's caches [B, H_kv, hd, T]
    (H_kv dividing H; see the module docstring):
    ``attention_dm_q8`` over int8 caches, :func:`attention_dm` over float
    caches read in q's dtype.  With ``with_weights`` also returns the
    float32 softmax weights [B, H, s, T]."""
    if kv.k_scale is None:
        return attention_dm(q, kv.k.to(q.dtype), kv.v.to(q.dtype), mask, with_weights)
    args = (q, kv.k, kv.k_scale, kv.v, kv.v_scale, mask)
    return attention_dm_q8_with_weights(*args) if with_weights else attention_dm_q8(*args)


def _grouped_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, s, H, hd] against dim-major k [B, H_kv, hd, T] (float32
    operands): [B, H_kv, H / H_kv, s, T], q head h against cache head
    h // (H / H_kv)."""
    b, s, h, hd = q.shape
    hk = k.shape[1]
    return torch.einsum("bskgd,bkdt->bkgst", q.reshape(b, s, hk, h // hk, hd), k)


def _grouped_pv(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Weights [B, H_kv, H / H_kv, s, T] times dim-major v [B, H_kv, hd, T]:
    [B, s, H, hd]."""
    return torch.einsum("bkgst,bkdt->bskgd", w, v).flatten(2, 3)


def attention_dm(q, k, v, mask, with_weights: bool = False):
    """Attention over float dim-major K/V [B, H_kv, hd, T]; with
    ``with_weights`` also returns the float32 softmax weights [B, H, s, T]."""
    scale = q.shape[-1] ** -0.5
    logits = _grouped_qk(q.float(), k.float()).flatten(1, 2) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = _grouped_pv(weights.to(q.dtype).unflatten(1, (k.shape[1], -1)), v)
    return (out, weights) if with_weights else out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-key-column symmetric int8 quantization.

    x: [..., hd, t] (dim-major) -> (q int8 [..., hd, t], scale f32 [..., t])
    with scale = amax over hd / 127 (1.0 where the column is all zero).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  On a CUDA
    tensor PyTorch computes ``amax / 127.0`` as the product with 1/127
    rounded to float32 (on the CPU it divides), so a scale's last bit may
    differ between the devices; K7 gives the card's.
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
    logits = _grouped_qk(q.float(), k_q.float()) * (k_s * scale)[:, :, None, None, :]
    logits = logits.flatten(1, 2)
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
    hk, t = k_q.shape[1], k_q.shape[3]
    if (tuple(k_q.shape) != (b, hk, hd, t) or hk < 1 or h % hk
            or v_q.shape != k_q.shape):
        raise ValueError(f"k_q and v_q must be [B, H_kv, hd, T] = [{b}, H_kv, {hd}, T] with "
                         f"H_kv dividing H = {h}; got {tuple(k_q.shape)} and {tuple(v_q.shape)}")
    if tuple(k_s.shape) != (b, hk, t) or v_s.shape != k_s.shape:
        raise ValueError(f"k_s and v_s must be [B, H_kv, T] = {(b, hk, t)}; got "
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
                       (ctypes.c_longlong * 6)(b, h, s, t, hd, k_q.shape[1]),
                       (ctypes.c_longlong * 18)(*strides), _DTYPE_CODES[q.dtype],
                       float(hd) ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"attention_dm_q8 launch failed with CUDA error {rc} (B={b}, s={s}, "
                           f"H={h}, H_kv={k_q.shape[1]}, hd={hd}, T={t}, {q.dtype})")
    profiling.count(Q8_LAUNCHES)
    return out


def _check_write(kv: LayerKV, k_new, v_new, cols) -> None:
    """What K7 takes: shapes, dtypes, strides, the rule's start, one CUDA
    device; raised before any launch."""
    k, v, k_s, v_s = kv
    if k_new.dim() != 4 or k.dim() != 4:
        raise ValueError(f"write_kv: the kernel takes K/V [B, H, hd, s] and caches [B, H, hd, T]; "
                         f"got {tuple(k_new.shape)} and {tuple(k.shape)}")
    b, h, hd, s = k_new.shape
    t = k.shape[3]
    if v_new.shape != k_new.shape or tuple(k.shape) != (b, h, hd, t) or v.shape != k.shape:
        raise ValueError(f"write_kv: K/V must be [B, H, hd, s] = {(b, h, hd, s)} and the caches "
                         f"[B, H, hd, T]; got {tuple(v_new.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if tuple(k_s.shape) != (b, h, t) or v_s.shape != k_s.shape:
        raise ValueError(f"write_kv: the scales must be [B, H, T] = {(b, h, t)}; got "
                         f"{tuple(k_s.shape)} and {tuple(v_s.shape)}")
    if k_new.dtype not in _WRITE_DTYPE_CODES or v_new.dtype != k_new.dtype:
        raise TypeError(f"write_kv: the kernel takes K and V in one of "
                        f"{list(_WRITE_DTYPE_CODES)}; got {k_new.dtype} and {v_new.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"write_kv: the caches must be int8; got {k.dtype} and {v.dtype}")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError(f"write_kv: the scales must be float32; got {k_s.dtype} and {v_s.dtype}")
    if hd > MAX_WRITE_HEAD_DIM or s > t:
        raise ValueError(f"write_kv: the kernel takes head_dim <= {MAX_WRITE_HEAD_DIM} and s <= T; "
                         f"got head_dim {hd}, s {s}, T {t}")
    if any(x.stride(-1) != 1 for x in kv):
        raise ValueError("write_kv: the caches and scales must have T stride 1")
    if torch.is_grad_enabled() and (k_new.requires_grad or v_new.requires_grad):
        raise RuntimeError("write_kv: the kernel has no backward, and K or V requires grad")
    tensors = [k_new, v_new, *kv]
    if isinstance(cols, Cursor):
        if not 0 <= cols.start <= t - s:
            raise ValueError(f"write_kv: columns [{cols.start}, {cols.start + s}) lie outside "
                             f"the caches' {t}")
    else:
        if cols.start.dtype not in _START_DTYPE_CODES or tuple(cols.start.shape) != (b,):
            raise TypeError(f"write_kv: per-row starts must be int32 or int64 [B] = [{b}]; got "
                            f"{cols.start.dtype} {tuple(cols.start.shape)}")
        tensors.append(cols.start)
    if any(x.device != k_new.device for x in tensors):
        raise ValueError("write_kv: K/V, the caches, their scales and the starts must lie on one "
                         "device")
    if k_new.device.type != "cuda":
        raise ValueError(f"write_kv: no kernel for device {k_new.device}")


@functools.cache
def _write_kernel():
    """K7's C entry point, built at first use, with its signature declared."""
    fn = _build.load("kv_write").kv_write
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_write(kv: LayerKV, k_new, v_new, cols) -> None:
    """Check what K7 takes, launch it on K's stream (one launch: K and V,
    values and scales), raise on a launch error.  Reads K, V and the
    per-row starts in place through their strides."""
    _check_write(kv, k_new, v_new, cols)
    b, h, hd, s = k_new.shape
    if k_new.numel() == 0:
        return
    k, v, k_s, v_s = kv
    rows = isinstance(cols, RowStarts)
    strides = (*k_new.stride(), *v_new.stride(), *k.stride()[:3], *v.stride()[:3],
               *k_s.stride()[:2], *v_s.stride()[:2], cols.start.stride(0) if rows else 0)
    with torch.cuda.device(k_new.device):
        stream = torch.cuda.current_stream(k_new.device).cuda_stream
        rc = _write_kernel()(
            k_new.data_ptr(), v_new.data_ptr(), k.data_ptr(), v.data_ptr(), k_s.data_ptr(),
            v_s.data_ptr(), cols.start.data_ptr() if rows else None,
            (ctypes.c_longlong * 5)(b, h, hd, s, k.shape[3]), (ctypes.c_longlong * 19)(*strides),
            _WRITE_DTYPE_CODES[k_new.dtype], _START_DTYPE_CODES[cols.start.dtype] if rows else 0,
            0 if rows else cols.start, stream)
    if rc != 0:
        raise RuntimeError(f"write_kv launch failed with CUDA error {rc} (B={b}, H={h}, hd={hd}, "
                           f"s={s}, T={k.shape[3]}, {k_new.dtype})")
    profiling.count(KV_WRITE_LAUNCHES)


def attention_dm_q8(
    q: torch.Tensor,    # [B, s, H, hd] float
    k_q: torch.Tensor,  # [B, H_kv, hd, T] int8 (H_kv dividing H)
    k_s: torch.Tensor,  # [B, H_kv, T] f32
    v_q: torch.Tensor,  # [B, H_kv, hd, T] int8
    v_s: torch.Tensor,  # [B, H_kv, T] f32
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
    wv = (weights.unflatten(1, (k_q.shape[1], -1)) * v_s[:, :, None, None, :]).to(q.dtype)
    out = _grouped_pv(wv, v_q.to(q.dtype))
    return out, weights
