"""LayerNorm over the last axis with float32 statistics.

Counterpart of the JAX package's ``layers.layer_norm``, which XLA fuses into
one pass.  ``layer_norm`` on CUDA tensors launches K6
(``csrc/layer_norm.cu``): the whole function in one launch, reading x once
and writing y once, in place of the eleven launches of the plain version
run eagerly.  It counts each launch in the recorder's
``launches.layer_norm`` (:data:`LN_LAUNCHES`).  The plain version below runs
for CPU tensors only.  A call that autograd records (x, the weight or the
bias requires grad while grad is enabled, as in a trainer's step) launches
K6 too, through :class:`LayerNormK6`, whose backward is the plain version's
gradient: it recomputes the plain forward from the saved x, weight and bias
and differentiates that.  K6 follows the plain version's rounding places;
only the order of its float32 sums differs.  Neither falls back to the
other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from . import _build

LN_LAUNCHES = "launches.layer_norm"  # the recorder's count of K6 launches
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The widest row K6 takes: its float32 values in one block's shared memory,
# less 1 KB (csrc/layer_norm.cu's kMaxWidth).
MAX_WIDTH = (232_448 - 1024) // 4


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32; no bias unless
    present."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _records_grad(x, weight, bias) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or (bias is not None and bias.requires_grad))


def row_stride(x: torch.Tensor) -> int | None:
    """The one stride (elements) that steps from each row of x (its last
    axis) to the next, or None where its leading axes do not flatten to one
    stride.  Axes of size 1 have no say."""
    step = expected = None
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if step is None:
            step = stride
        elif stride != expected:
            return None
        expected = stride * size
    return x.shape[-1] if step is None else step


def _check(x, weight, bias) -> None:
    """What K6 takes: dtypes, the parameters' shape, one device."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm: the kernel takes x in {list(_DTYPE_CODES)}; got {x.dtype}")
    if weight.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm: the kernel takes the weight in {list(_DTYPE_CODES)}; got "
                        f"{weight.dtype}")
    if bias is not None and bias.dtype != weight.dtype:
        raise TypeError(f"layer_norm: the kernel takes the bias in the weight's dtype "
                        f"{weight.dtype}; got {bias.dtype}")
    if x.dim() == 0:
        raise ValueError("layer_norm: x must have a last axis")
    width = x.shape[-1]
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"layer_norm: the kernel takes widths 1 to {MAX_WIDTH}; got {width}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if tuple(p.shape) != (width,) or (width > 1 and p.stride(0) != 1):
            raise ValueError(f"layer_norm: the {name} must be a contiguous [{width}]; got shape "
                             f"{tuple(p.shape)}, strides {tuple(p.stride())}")
        if p.device != x.device:
            raise ValueError(f"layer_norm: x is on {x.device} and the {name} on {p.device}")
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")


@functools.cache
def _kernel():
    """K6's C entry point, built at first use, with its signature declared
    (without ``argtypes`` ctypes would pass each pointer as a 32-bit int)."""
    fn = _build.load("layer_norm").layer_norm
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weight, bias, eps) -> torch.Tensor:
    """Check what K6 takes, launch it on x's stream, raise on a launch error;
    returns y contiguous in x's shape and dtype.  x is read in place where
    its rows lie one stride apart along a unit-stride last axis, and made
    contiguous first otherwise."""
    _check(x, weight, bias)
    stride = row_stride(x) if x.stride(-1) == 1 or x.shape[-1] == 1 else None
    if stride is None:
        x = x.contiguous()
        stride = x.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    width = x.shape[-1]
    rows = x.numel() // width
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(x.data_ptr(), weight.data_ptr(),
                       None if bias is None else bias.data_ptr(), y.data_ptr(), rows, width,
                       stride, _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], eps, stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm launch failed with CUDA error {rc} (rows={rows}, "
                           f"width={width}, {x.dtype}, weight {weight.dtype})")
    profiling.count(LN_LAUNCHES)
    return y


class LayerNormK6(torch.autograd.Function):
    """K6 forward; the plain version's gradient backward (recomputed from
    the saved inputs, so no statistics are kept between the passes)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _launch(x, weight, bias, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(layer_norm_plain(*leaves, ctx.eps), wanted, grad))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in leaves),
                None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32, in x's dtype: the
    plain version on CPU tensors, K6 otherwise (see the module docstring)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    # Both routes launch K6; ``apply`` adds microseconds of host time a
    # call, and the decode steps' enqueue already holds their wall.
    if _records_grad(x, weight, bias):
        return LayerNormK6.apply(x, weight, bias, eps)
    return _launch(x, weight, bias, eps)
