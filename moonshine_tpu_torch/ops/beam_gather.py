"""Beam-reorder row gather: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/beam_gather.py`` (the Pallas
``_gather_kernel`` and ``_gather_scale_kernel``).  Beam search reorders the
self-KV caches by parent index at every step: destination row ``n`` of
axis 1 takes source row ``idx[n]``, for two arrays at once.

    gather_kv_rows(k_self, v_self, idx)     caches [L, N, H, hd, S]
    gather_scale_rows(k_scale, v_scale, idx)  int8-KV scales [L, N, H, S]

Both return fresh tensors, never views of their inputs: the decoder writes
the self caches in place, so a view would let one beam's write land in
another's row.  CPU tensors take the plain version (``index_select``);
CUDA tensors launch the kernel (``csrc/beam_gather.cu``) and count the
launch on the wrapper.  Neither falls back to the other.  The kernel
reads ``idx`` on the card and traps on an index outside ``[0, N)``; the
wrapper never reads the indices on the host, which would wait for the
stream at every decode step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8)  # the decoder caches' dtypes
SCALE_DTYPES = (torch.float32,)


def _gather_rows_torch(a: torch.Tensor, b: torch.Tensor,
                       idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of both kernels: ``index_select`` along axis 1."""
    return a.index_select(1, idx), b.index_select(1, idx)


def _check(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor, ndim: int,
           dtypes: tuple, what: str) -> None:
    if a.dim() != ndim or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"{what}: want two arrays of one {ndim}-D shape; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"{what}: dtype must be one of {list(dtypes)} and shared; got "
                        f"{a.dtype} and {b.dtype}")
    if idx.dim() != 1 or idx.shape[0] != a.shape[1]:
        raise ValueError(f"{what}: idx must be 1-D of length {a.shape[1]} (axis 1); got "
                         f"{tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: idx must be int32 or int64, got {idx.dtype}")
    if b.device != a.device or idx.device != a.device:
        raise ValueError(f"{what}: arrays and idx must lie on one device; got "
                         f"{a.device}, {b.device}, {idx.device}")


@functools.cache
def _kernel():
    """The kernel's C entry point, built at first use, with its signature
    declared (without ``argtypes`` ctypes would pass each pointer as a
    32-bit int)."""
    fn = _build.load("beam_gather").beam_gather_rows
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, a: torch.Tensor, b: torch.Tensor,
            idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel for ``wrapper`` and count the launch on it."""
    what = wrapper.__name__
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: arrays must be contiguous")
    layers, rows = a.shape[0], a.shape[1]
    if layers > 65535 or rows > 2**31 - 1:
        raise ValueError(f"{what}: the kernel takes L <= 65535 and N < 2^31; got "
                         f"L={layers}, N={rows}")
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    if a.numel() == 0:
        return out_a, out_b
    idx32 = idx.to(torch.int32).contiguous()  # on the card: no host sync
    row_bytes = a[0, 0].numel() * a.element_size()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _kernel()(a.data_ptr(), b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                       idx32.data_ptr(), layers, rows, row_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc} "
                           f"(shape {tuple(a.shape)}, {a.dtype})")
    wrapper.launches += 1
    return out_a, out_b


def gather_kv_rows(
    k_self: torch.Tensor,  # [L, N, H, hd, S]
    v_self: torch.Tensor,  # [L, N, H, hd, S]
    idx: torch.Tensor,  # [N] int32 (or int64) source row per destination row
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(k_self[:, idx], v_self[:, idx])`` as fresh tensors."""
    _check(k_self, v_self, idx, 5, KV_DTYPES, "gather_kv_rows")
    if k_self.device.type == "cpu":
        return _gather_rows_torch(k_self, v_self, idx)
    return _launch(gather_kv_rows, k_self, v_self, idx)


def gather_scale_rows(
    k_scale: torch.Tensor,  # [L, N, H, S] float32 per-column int8-KV scales
    v_scale: torch.Tensor,  # [L, N, H, S]
    idx: torch.Tensor,  # [N] int32 (or int64)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row gather of the int8-KV scale arrays (the same copy as
    :func:`gather_kv_rows`, on 4-D float32 arrays)."""
    _check(k_scale, v_scale, idx, 4, SCALE_DTYPES, "gather_scale_rows")
    if k_scale.device.type == "cpu":
        return _gather_rows_torch(k_scale, v_scale, idx)
    return _launch(gather_scale_rows, k_scale, v_scale, idx)


gather_kv_rows.launches = 0
gather_scale_rows.launches = 0
