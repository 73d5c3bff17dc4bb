"""Execute small ONNX graphs as PyTorch programs.

Counterpart of the JAX package's ``ops/onnx_graph.py``: the interpreter
that runs the reference's in-tree real weights (the TinyVadCNN speech
classifier, the spelling CNN, vocoder graphs) without an ONNX runtime.
Its design is JAX's:

- shape and constant plumbing (Constant, Reshape of constants, Concat,
  Slice, Shape, Range, ...) folds eagerly in numpy, so an int64 shape
  tensor never becomes a device tensor;
- only the data path runs as torch ops, in NCHW/OIHW exactly as exported.

Where torch's ops take less than ONNX says, the interpreter does the rest
itself: asymmetric Conv pads are applied with ``F.pad`` first, MaxPool pads
with ``-inf`` first (torch limits its own padding to half the kernel), a
ConvTranspose runs unpadded and is then cropped and padded to ONNX's size,
and a Slice with a negative step becomes an index gather.

Graph initializers are copied to the data's device once and kept with the
graph, so that a call does not copy weights from the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.onnx_io import OnnxGraph


def _is_const(x) -> bool:
    return isinstance(x, np.ndarray) or np.isscalar(x)


_ONNX_DT_TO_NP = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_, 11: np.float64}
# numpy -> torch dtypes of data-path values.  float64 runs as float32, as
# the JAX package does with 64-bit types off.
_NP_TO_TORCH = {np.float32: torch.float32, np.int32: torch.int32, np.int64: torch.int64,
                np.bool_: torch.bool, np.float64: torch.float32}


class _Ctx:
    """The device of one execution, and the graph's cache of initializers
    already on that device."""

    def __init__(self, graph: OnnxGraph, device: torch.device):
        self.device = device
        cache = graph.__dict__.setdefault("_torch_initializers", {})
        self.cache = cache.setdefault(str(device), {})
        self.init_ids = {id(v) for v in graph.initializers.values()}

    def t(self, x) -> torch.Tensor:
        """A data-path tensor of ``x`` (a torch tensor is returned as is)."""
        if isinstance(x, torch.Tensor):
            return x
        key = id(x)
        hit = self.cache.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if key in self.init_ids:
            self.cache[key] = (x, out)
        return out


def _conv_fn(nd: int):
    return {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]


def _bias(out: torch.Tensor, b, ctx: _Ctx, nd: int) -> torch.Tensor:
    if b is None:
        return out
    return out + ctx.t(b).reshape((1, -1) + (1,) * nd)


def _conv(x, w, b, attrs, ctx: _Ctx):
    """ONNX Conv, spatial rank 1-3; ``pads`` may be asymmetric."""
    w = ctx.t(w)
    nd = w.dim() - 2
    group = int(attrs.get("group", 1))
    strides = tuple(int(s) for s in attrs.get("strides", [1] * nd))
    dil = tuple(int(d) for d in attrs.get("dilations", [1] * nd))
    pads = [int(p) for p in attrs.get("pads", [0] * 2 * nd)]  # [begin..., end...]
    # F.pad lists the last axis first.
    x = F.pad(x, [p for i in reversed(range(nd)) for p in (pads[i], pads[i + nd])])
    out = _conv_fn(nd)(x, w.to(x.dtype), stride=strides, dilation=dil, groups=group)
    return _bias(out, b, ctx, nd)


def _conv_transpose(x, w, b, attrs, ctx: _Ctx):
    """ONNX ConvTranspose: the unpadded transposed convolution (size
    (in-1)*s + eff_k), then ``pads`` cropped from each side and
    ``output_padding`` rows (no kernel term reaches them) added at the end,
    so out = (in-1)*s - pad_b - pad_e + eff_k + output_padding."""
    w = ctx.t(w)  # ONNX layout [Cin, Cout/g, *k], torch's too
    nd = w.dim() - 2
    group = int(attrs.get("group", 1))
    strides = tuple(int(s) for s in attrs.get("strides", [1] * nd))
    dil = tuple(int(d) for d in attrs.get("dilations", [1] * nd))
    pads = [int(p) for p in attrs.get("pads", [0] * 2 * nd)]
    opad = [int(p) for p in attrs.get("output_padding", [0] * nd)]
    if "output_shape" in attrs:
        raise NotImplementedError("ConvTranspose output_shape attribute")
    fn = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}[nd]
    out = fn(x, w.to(x.dtype), stride=strides, dilation=dil, groups=group)
    for i in range(nd):
        axis = 2 + i
        full = out.shape[axis]
        size = full - pads[i] - pads[nd + i] + opad[i]
        extra = max(pads[i] + size - full, 0)
        if extra:
            widths = [0, 0] * (out.dim() - 1 - axis) + [0, extra]
            out = F.pad(out, widths)
        out = out.narrow(axis, pads[i], size)
    return _bias(out, b, ctx, nd)


def _gemm(a, b, c, attrs, ctx: _Ctx):
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    a = ctx.t(a)
    if int(attrs.get("transA", 0)):
        a = a.T
    if int(attrs.get("transB", 0)):
        b = np.asarray(b).T if _is_const(b) else b.T
    out = alpha * (a @ ctx.t(b))
    if c is not None:
        out = out + beta * ctx.t(c)
    return out


_PAD_MODES = {"reflect": "reflect", "edge": "replicate", "wrap": "circular"}


def _pad(x, pads, value, attrs):
    pads = np.asarray(pads).reshape(-1)
    rank = x.dim()
    widths = [int(p) for i in reversed(range(rank)) for p in (pads[i], pads[i + rank])]
    mode = attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode != "constant":
        # torch pads only trailing axes in these modes: drop the leading
        # axes that are not padded.
        while len(widths) > 2 and widths[-2:] == [0, 0]:
            widths = widths[:-2]
        return F.pad(x, widths, mode=_PAD_MODES[mode])
    v = 0.0 if value is None else float(np.asarray(value).reshape(()))
    return F.pad(x, widths, value=v)


def _slice(data, starts, ends, axes=None, steps=None):
    starts = np.asarray(starts).reshape(-1)
    ends = np.asarray(ends).reshape(-1)
    axes = np.arange(len(starts)) if axes is None else np.asarray(axes).reshape(-1)
    steps = np.ones(len(starts), np.int64) if steps is None else np.asarray(steps).reshape(-1)
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % data.ndim
        dim = data.shape[a]
        s, e, st = int(s), int(e), int(st)
        if st > 0:
            s = max(s + dim, 0) if s < 0 else min(s, dim)
            e = max(e + dim, 0) if e < 0 else min(e, dim)
        else:
            # Negative step: ONNX clamps start to [0, dim-1]; an end below
            # -dim means "through the first element".
            s = min(max(s + dim if s < 0 else s, 0), dim - 1)
            e = -1 if e < -dim else (e + dim if e < 0 else min(e, dim))
        idx = np.arange(s, e, st)
        if _is_const(data):
            data = np.take(np.asarray(data), idx, axis=a)
        elif st > 0:
            data = data[(slice(None),) * a + (slice(s, e, st),)]
        else:
            data = data.index_select(a, torch.as_tensor(idx, device=data.device))
    return data


def _take(x, idx, axis: int, ctx: _Ctx):
    """``jnp.take``: out = x.shape[:axis] + idx.shape + x.shape[axis+1:]."""
    x = ctx.t(x)
    idx = ctx.t(np.asarray(idx, np.int64) if _is_const(idx) else idx).long()
    axis = axis % x.dim()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _reduce_axes(a, ins):
    axes = a.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = np.asarray(ins[1]).reshape(-1)
    return None if axes is None else tuple(int(v) for v in axes)


def _torch_reduce(fn, x, axes, keep):
    if axes == ():
        return x  # jnp reduces over no axis here; torch's dim=() would take all
    if axes is None:
        axes = tuple(range(x.dim()))
    return fn(x, dim=axes, keepdim=keep)


_UNARY = {
    "Relu": torch.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh, "Exp": torch.exp,
    "Log": torch.log, "Neg": torch.neg, "Abs": torch.abs, "Ceil": torch.ceil,
    "Floor": torch.floor, "Sin": torch.sin, "Cos": torch.cos, "Sqrt": torch.sqrt,
}
_BINARY = {"Add": "__add__", "Sub": "__sub__", "Mul": "__mul__", "Div": "__truediv__"}
_COMPARE = {
    "Equal": (np.equal, torch.eq), "Less": (np.less, torch.lt),
    "Greater": (np.greater, torch.gt), "LessOrEqual": (np.less_equal, torch.le),
    "GreaterOrEqual": (np.greater_equal, torch.ge),
}
_REDUCE = {
    "ReduceMean": (np.mean, torch.mean), "ReduceSum": (np.sum, torch.sum),
    "ReduceMax": (np.max, torch.amax), "ReduceMin": (np.min, torch.amin),
}


def _run_node(node, vals, ctx: _Ctx):
    """Compute one node given resolved input values. Returns output value(s)."""
    ins = [vals[n] if n else None for n in node.inputs]
    op = node.op_type
    a = node.attrs
    t = ctx.t
    if op == "Constant":
        return a.get("value")
    if op == "ConstantOfShape":
        shape = tuple(int(v) for v in np.asarray(ins[0]).reshape(-1))
        fill = a.get("value")
        fill = np.zeros(1, np.float32) if fill is None else np.asarray(fill).reshape(-1)
        return np.full(shape, fill[0], dtype=fill.dtype)
    if op == "Conv":
        return _conv(t(ins[0]), ins[1], ins[2] if len(ins) > 2 else None, a, ctx)
    if op == "Clip":
        lo = ins[1] if len(ins) > 1 else a.get("min")
        hi = ins[2] if len(ins) > 2 else a.get("max")
        x = t(ins[0])
        if lo is not None:
            x = torch.maximum(x, t(np.asarray(lo)).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, t(np.asarray(hi)).to(x.dtype))
        return x
    if op in _UNARY:
        return _UNARY[op](t(ins[0]))
    if op == "Softmax":
        return torch.softmax(t(ins[0]), dim=int(a.get("axis", -1)))
    if op in _BINARY:
        x, y = ins[0], ins[1]
        if _is_const(x) and _is_const(y):
            return getattr(np.asarray(x), _BINARY[op])(np.asarray(y))
        return getattr(t(x), _BINARY[op])(t(y))
    if op == "GlobalAveragePool":
        return t(ins[0]).mean(dim=(2, 3), keepdim=True)
    if op == "AveragePool":
        k = tuple(int(v) for v in a["kernel_shape"])
        s = tuple(int(v) for v in a.get("strides", k))
        fn = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[len(k)]
        return fn(t(ins[0]), k, s)
    if op == "MaxPool":
        k = tuple(int(v) for v in a["kernel_shape"])
        s = tuple(int(v) for v in a.get("strides", k))
        nd = len(k)
        pads = [int(p) for p in a.get("pads", [0] * 2 * nd)]
        x = F.pad(t(ins[0]), [p for i in reversed(range(nd)) for p in (pads[i], pads[i + nd])],
                  value=-math.inf)
        fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
        return fn(x, k, s)
    if op == "Flatten":
        ax = int(a.get("axis", 1))
        lead = int(np.prod(ins[0].shape[:ax])) if ax else 1
        return ins[0].reshape(lead, -1)
    if op == "Reshape":
        shape = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
        if _is_const(ins[0]):
            return np.asarray(ins[0]).reshape(shape)
        return ins[0].reshape(shape)
    if op == "Transpose":
        perm = a.get("perm")
        if _is_const(ins[0]):
            return np.transpose(np.asarray(ins[0]), perm)
        x = ins[0]
        return x.permute(*(reversed(range(x.dim())) if perm is None else perm))
    if op == "Concat":
        axis = int(a.get("axis", 0))
        if all(_is_const(x) for x in ins):
            return np.concatenate([np.asarray(x) for x in ins], axis=axis)
        parts = [t(x) for x in ins]
        dtype = parts[0].dtype
        for p in parts[1:]:
            dtype = torch.promote_types(dtype, p.dtype)
        return torch.cat([p.to(dtype) for p in parts], dim=axis)
    if op == "Cast":
        to = _ONNX_DT_TO_NP[int(a["to"])]
        if _is_const(ins[0]):
            return np.asarray(ins[0]).astype(to)
        return ins[0].to(_NP_TO_TORCH[to])
    if op == "Slice":
        return _slice(*ins)
    if op == "Shape":
        return np.asarray(tuple(ins[0].shape), np.int64)
    if op == "Gemm":
        return _gemm(ins[0], ins[1], ins[2] if len(ins) > 2 else None, a, ctx)
    if op == "MatMul":
        return t(ins[0]) @ t(ins[1])
    if op == "Pad":
        return _pad(t(ins[0]), ins[1], ins[2] if len(ins) > 2 else None, a)
    if op == "Unsqueeze":
        axes = [int(v) for v in np.asarray(ins[1] if len(ins) > 1 else a["axes"]).reshape(-1)]
        x = ins[0]
        for ax in sorted(axes):
            x = np.expand_dims(x, ax) if _is_const(x) else x.unsqueeze(ax)
        return x
    if op == "Squeeze":
        axes = [int(v) for v in
                np.asarray(ins[1] if len(ins) > 1 else a.get("axes", [])).reshape(-1)]
        if _is_const(ins[0]):
            return np.squeeze(np.asarray(ins[0]), axis=tuple(axes) or None)
        return ins[0].squeeze(tuple(axes)) if axes else ins[0].squeeze()
    if op == "Identity":
        return ins[0]
    if op == "BatchNormalization":
        x, scale, bias, mean, var = ins[:5]
        x = t(x)
        eps = float(a.get("epsilon", 1e-5))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = t(scale) / torch.sqrt(t(var) + eps)
        return x * inv.reshape(shape) + (t(bias) - t(mean) * inv).reshape(shape)
    # -- vocoder/transformer-class ops (HiFiGAN/Vocos-style graphs) --------
    if op == "ConvTranspose":
        return _conv_transpose(t(ins[0]), ins[1], ins[2] if len(ins) > 2 else None, a, ctx)
    if op == "LeakyRelu":
        alpha = float(a.get("alpha", 0.01))
        x = t(ins[0])
        return torch.where(x >= 0, x, alpha * x)
    if op == "PRelu":
        x = t(ins[0])
        return torch.where(x >= 0, x, t(ins[1]) * x)
    if op == "Elu":
        alpha = float(a.get("alpha", 1.0))
        x = t(ins[0])
        return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))
    if op == "Softplus":
        x = t(ins[0])
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
    if op == "Pow":
        x = t(ins[0])
        return x ** t(np.asarray(ins[1]) if _is_const(ins[1]) else ins[1]).to(x.dtype)
    if op == "Erf":
        return torch.erf(t(ins[0]))
    if op == "Gelu":
        approx = a.get("approximate", b"none")
        approx = approx.decode() if isinstance(approx, bytes) else approx
        return F.gelu(t(ins[0]), approximate="tanh" if approx == "tanh" else "none")
    if op == "Gather":
        axis = int(a.get("axis", 0))
        idx = ins[1]
        if _is_const(ins[0]) and _is_const(idx):
            return np.take(np.asarray(ins[0]), np.asarray(idx, np.int64), axis=axis)
        return _take(ins[0], idx, axis, ctx)
    if op == "Split":
        axis = int(a.get("axis", 0))
        x = t(ins[0])
        if len(ins) > 1 and ins[1] is not None:
            sizes = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
        elif "split" in a:
            sizes = [int(v) for v in a["split"]]
        else:
            n = int(a["num_outputs"])
            sizes = [x.shape[axis] // n] * n
        return list(torch.split(x, sizes, dim=axis))
    if op in _REDUCE:
        axes = _reduce_axes(a, ins)
        keep = bool(int(a.get("keepdims", 1)))
        np_fn, torch_fn = _REDUCE[op]
        if _is_const(ins[0]):
            return np.asarray(np_fn(np.asarray(ins[0]), axis=axes, keepdims=keep))
        return _torch_reduce(torch_fn, ins[0], axes, keep)
    if op == "Where":
        if all(_is_const(x) for x in ins):
            return np.where(np.asarray(ins[0]), np.asarray(ins[1]), np.asarray(ins[2]))
        return torch.where(t(ins[0]).bool(), t(ins[1]), t(ins[2]))
    if op in _COMPARE:
        np_fn, torch_fn = _COMPARE[op]
        if all(_is_const(x) for x in ins[:2]):
            return np.asarray(np_fn(np.asarray(ins[0]), np.asarray(ins[1])))
        return torch_fn(t(ins[0]), t(ins[1]))
    if op == "Not":
        return ~np.asarray(ins[0]) if _is_const(ins[0]) else ~ins[0]
    if op == "Expand":
        shape = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
        # ONNX Expand is bidirectional broadcast.
        target = np.broadcast_shapes(tuple(np.shape(ins[0])), tuple(shape))
        if _is_const(ins[0]):
            return np.broadcast_to(np.asarray(ins[0]), target)
        return ins[0].expand(target)
    if op == "Range":
        start, limit, delta = (np.asarray(v).reshape(()) for v in ins[:3])
        return np.arange(start, limit, delta)
    if op == "CumSum":
        axis = int(np.asarray(ins[1]).reshape(()))
        if _is_const(ins[0]):
            return np.cumsum(np.asarray(ins[0]), axis=axis)
        return torch.cumsum(ins[0], dim=axis)
    if op == "LayerNormalization":
        x, scale = t(ins[0]), t(ins[1])
        axis = int(a.get("axis", -1))
        eps = float(a.get("epsilon", 1e-5))
        dims = tuple(range(axis % x.dim(), x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, correction=0)
        y = (x - mean) / torch.sqrt(var + eps) * scale
        if len(ins) > 2 and ins[2] is not None:
            y = y + t(ins[2])
        return y
    if op == "InstanceNormalization":
        x, scale, bias = t(ins[0]), t(ins[1]), t(ins[2])
        eps = float(a.get("epsilon", 1e-5))
        dims = tuple(range(2, x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, correction=0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)
    if op == "ReduceL2":
        axes = _reduce_axes(a, ins)
        keep = bool(int(a.get("keepdims", 1)))
        return torch.sqrt(_torch_reduce(torch.sum, torch.square(t(ins[0])), axes, keep))
    raise NotImplementedError(f"ONNX op {op} not supported by onnx_graph executor")


def _device(feeds: dict) -> torch.device:
    for v in feeds.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def execute(graph: OnnxGraph, feeds: dict[str, torch.Tensor]) -> list[torch.Tensor]:
    """Run ``graph`` on ``feeds`` (name -> tensor) on the feeds' device.
    Returns the graph's outputs in order, as tensors."""
    ctx = _Ctx(graph, _device(feeds))
    vals: dict[str, object] = dict(graph.initializers)
    vals.update(feeds)
    for node in graph.nodes:
        outs = _run_node(node, vals, ctx)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for name, v in zip(node.outputs, outs):
            vals[name] = v
    return [ctx.t(vals[name]) for name, _ in graph.outputs]


def compile_graph(graph: OnnxGraph):
    """fn(x) -> output tensor, for single-input graphs."""
    (input_name, _), = graph.inputs

    @torch.inference_mode()
    def fn(x):
        return execute(graph, {input_name: x})[0]

    return fn
