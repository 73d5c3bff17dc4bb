"""The port's ONNX interpreter against the JAX package's, on the CPU: one
single-node graph per op type, the same graph object and the same seeded
inputs through both ``execute``s.  Asymmetric Conv and MaxPool pads, a
ConvTranspose with output padding, Gemm's transposes and scales, Slice's
negative and INT64_MAX bounds and the Reduce ops' axes conventions are
among the cases.

Tolerances: float outputs to atol = rtol = 1e-5 (products and
convolutions sum in another order); integer, boolean and folded constant
outputs must be equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.ops.onnx_graph import execute as jax_execute
from moonshine_tpu_torch.core.onnx_io import OnnxGraph, OnnxNode
from moonshine_tpu_torch.ops import onnx_graph as tog

INT64_MAX = np.iinfo(np.int64).max
TOL = dict(atol=1e-5, rtol=1e-5)


def _r(*shape, seed=0, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _i(*vals):
    return np.asarray(vals, np.int64)


# name -> (op, feeds, initializers, node inputs, attrs, number of outputs).
# Feeds become data-path tensors; initializers stay numpy constants.
X4 = {"x": _r(2, 3, 7, 9)}
X3 = {"x": _r(2, 4, 10)}
X2 = {"x": _r(5, 6)}
CASES = {
    "Conv2d_asym_pads": ("Conv", X4, {"w": _r(4, 3, 3, 2, seed=1), "b": _r(4, seed=2)},
                         ["x", "w", "b"],
                         dict(pads=[1, 0, 2, 1], strides=[2, 1], dilations=[1, 2]), 1),
    "Conv1d_group": ("Conv", X3, {"w": _r(6, 2, 3, seed=1)}, ["x", "w"],
                     dict(pads=[2, 1], group=2), 1),
    "Clip_inputs": ("Clip", X2, {"lo": np.float32(-0.5), "hi": np.float32(0.7)},
                    ["x", "lo", "hi"], {}, 1),
    "Clip_min_only": ("Clip", X2, {"lo": np.float32(-0.2)}, ["x", "lo"], {}, 1),
    "Relu": ("Relu", X4, {}, ["x"], {}, 1),
    "Sigmoid": ("Sigmoid", X2, {}, ["x"], {}, 1),
    "Softmax": ("Softmax", X4, {}, ["x"], dict(axis=1), 1),
    "Add": ("Add", X4, {"c": _r(1, 3, 1, 9, seed=1)}, ["x", "c"], {}, 1),
    "Sub": ("Sub", X2, {"c": _r(6, seed=1)}, ["c", "x"], {}, 1),
    "Mul": ("Mul", X2, {"c": np.float32(1.5)}, ["x", "c"], {}, 1),
    "Div": ("Div", X2, {"c": _r(5, 1, seed=1, positive=True)}, ["x", "c"], {}, 1),
    "GlobalAveragePool": ("GlobalAveragePool", X4, {}, ["x"], {}, 1),
    "AveragePool": ("AveragePool", X4, {}, ["x"], dict(kernel_shape=[2, 3], strides=[2, 1]), 1),
    "MaxPool_asym_pads": ("MaxPool", X4, {}, ["x"],
                          dict(kernel_shape=[3, 3], strides=[2, 2], pads=[0, 1, 2, 1]), 1),
    "MaxPool_wide_pads": ("MaxPool", X4, {}, ["x"],
                          dict(kernel_shape=[2, 2], strides=[1, 1], pads=[2, 0, 0, 2]), 1),
    "Flatten": ("Flatten", X4, {}, ["x"], dict(axis=2), 1),
    "Reshape": ("Reshape", X4, {"s": _i(2, -1, 9)}, ["x", "s"], {}, 1),
    "Transpose": ("Transpose", X4, {}, ["x"], dict(perm=[0, 2, 3, 1]), 1),
    "Transpose_default": ("Transpose", X4, {}, ["x"], {}, 1),
    "Concat": ("Concat", X2, {"c": _r(5, 2, seed=1)}, ["x", "c"], dict(axis=1), 1),
    "Cast_int32": ("Cast", {"x": _r(5, 6) * 4}, {}, ["x"], dict(to=6), 1),
    "Cast_const": ("Cast", {}, {"c": _r(3, 4)}, ["c"], dict(to=7), 1),
    "Slice_neg_start_int64max_end": ("Slice", X4, {"s": _i(-5, 1), "e": _i(INT64_MAX, 3),
                                                   "a": _i(3, 1), "st": _i(2, 1)},
                                     ["x", "s", "e", "a", "st"], {}, 1),
    "Slice_negative_step": ("Slice", X4, {"s": _i(-1), "e": _i(-INT64_MAX), "a": _i(2),
                                          "st": _i(-2)}, ["x", "s", "e", "a", "st"], {}, 1),
    "Slice_default_axes": ("Slice", X2, {"s": _i(1, 2), "e": _i(4, -1)}, ["x", "s", "e"],
                           {}, 1),
    "Shape": ("Shape", X4, {}, ["x"], {}, 1),
    "Gemm_transposes": ("Gemm", {"x": _r(6, 5)}, {"b": _r(4, 6, seed=1), "c": _r(4, seed=2)},
                        ["x", "b", "c"], dict(transA=1, transB=1, alpha=0.5, beta=2.0), 1),
    "Gemm_plain": ("Gemm", X2, {"b": _r(6, 3, seed=1)}, ["x", "b"], {}, 1),
    "MatMul": ("MatMul", X4, {"w": _r(9, 4, seed=1)}, ["x", "w"], {}, 1),
    "Pad_constant": ("Pad", X4, {"p": _i(0, 1, 2, 0, 0, 0, 1, 3), "v": np.float32(0.25)},
                     ["x", "p", "v"], {}, 1),
    "Pad_reflect": ("Pad", X3, {"p": _i(0, 0, 2, 0, 0, 3)}, ["x", "p"], dict(mode=b"reflect"),
                    1),
    "Pad_edge": ("Pad", X4, {"p": _i(0, 0, 1, 2, 0, 0, 2, 1)}, ["x", "p"], dict(mode=b"edge"),
                 1),
    "Unsqueeze": ("Unsqueeze", X2, {"a": _i(0, 3)}, ["x", "a"], {}, 1),
    "Unsqueeze_attr": ("Unsqueeze", X2, {}, ["x"], dict(axes=[1]), 1),
    "Squeeze": ("Squeeze", {"x": _r(5, 1, 6, 1)}, {"a": _i(1)}, ["x", "a"], {}, 1),
    "Squeeze_all": ("Squeeze", {"x": _r(5, 1, 6, 1)}, {}, ["x"], {}, 1),
    "Identity": ("Identity", X2, {}, ["x"], {}, 1),
    "BatchNormalization": ("BatchNormalization", X4,
                           {"sc": _r(3, seed=1), "bi": _r(3, seed=2), "me": _r(3, seed=3),
                            "va": _r(3, seed=4, positive=True)},
                           ["x", "sc", "bi", "me", "va"], dict(epsilon=1e-3), 1),
    "ConvTranspose2d": ("ConvTranspose", {"x": _r(2, 4, 5, 6)},
                        {"w": _r(4, 3, 3, 4, seed=1), "b": _r(6, seed=2)}, ["x", "w", "b"],
                        dict(strides=[2, 3], pads=[1, 0, 0, 2], output_padding=[1, 2],
                             group=2, dilations=[1, 1]), 1),
    "ConvTranspose1d_dilated": ("ConvTranspose", X3, {"w": _r(4, 2, 3, seed=1)}, ["x", "w"],
                                dict(strides=[2], pads=[1, 1], dilations=[2]), 1),
    "LeakyRelu": ("LeakyRelu", X2, {}, ["x"], dict(alpha=0.2), 1),
    "PRelu": ("PRelu", X4, {"s": _r(3, 1, 1, seed=1)}, ["x", "s"], {}, 1),
    "Elu": ("Elu", X2, {}, ["x"], dict(alpha=0.7), 1),
    "Tanh": ("Tanh", X2, {}, ["x"], {}, 1),
    "Softplus": ("Softplus", {"x": _r(5, 6) * 30}, {}, ["x"], {}, 1),
    "Exp": ("Exp", X2, {}, ["x"], {}, 1),
    "Log": ("Log", {"x": _r(5, 6, positive=True)}, {}, ["x"], {}, 1),
    "Neg": ("Neg", X2, {}, ["x"], {}, 1),
    "Abs": ("Abs", X2, {}, ["x"], {}, 1),
    "Ceil": ("Ceil", {"x": _r(5, 6) * 3}, {}, ["x"], {}, 1),
    "Floor": ("Floor", {"x": _r(5, 6) * 3}, {}, ["x"], {}, 1),
    "Sin": ("Sin", X2, {}, ["x"], {}, 1),
    "Cos": ("Cos", X2, {}, ["x"], {}, 1),
    "Pow": ("Pow", {"x": _r(5, 6, positive=True)}, {"p": np.float32(1.7)}, ["x", "p"], {}, 1),
    "Sqrt": ("Sqrt", {"x": _r(5, 6, positive=True)}, {}, ["x"], {}, 1),
    "Erf": ("Erf", X2, {}, ["x"], {}, 1),
    "Gelu": ("Gelu", X2, {}, ["x"], {}, 1),
    "Gelu_tanh": ("Gelu", X2, {}, ["x"], dict(approximate=b"tanh"), 1),
    "Gather": ("Gather", X4, {"i": np.asarray([[0, -1], [2, 1]], np.int64)}, ["x", "i"],
               dict(axis=1), 1),
    "Gather_const": ("Gather", {}, {"c": _r(4, 5), "i": _i(3, 0)}, ["c", "i"], {}, 1),
    "Split_sizes": ("Split", X4, {"s": _i(2, 7)}, ["x", "s"], dict(axis=3), 2),
    "Split_num_outputs": ("Split", X3, {}, ["x"], dict(axis=1, num_outputs=2), 2),
    "ReduceMean": ("ReduceMean", X4, {}, ["x"], dict(axes=[1, 3], keepdims=1), 1),
    "ReduceSum_axes_input": ("ReduceSum", X4, {"a": _i(-1)}, ["x", "a"], dict(keepdims=0), 1),
    "ReduceMax_all": ("ReduceMax", X4, {}, ["x"], dict(keepdims=0), 1),
    "ReduceMin": ("ReduceMin", X4, {}, ["x"], dict(axes=[2]), 1),
    "ReduceL2": ("ReduceL2", X4, {}, ["x"], dict(axes=[2, 3], keepdims=0), 1),
    "Where": ("Where", X2, {"c": np.random.default_rng(5).random((5, 6)) < 0.5,
                            "y": _r(6, seed=1)}, ["c", "x", "y"], {}, 1),
    "Equal": ("Equal", {"x": np.round(_r(5, 6))}, {"c": np.float32(0.0)}, ["x", "c"], {}, 1),
    "Less": ("Less", X2, {"c": _r(6, seed=1)}, ["x", "c"], {}, 1),
    "Greater": ("Greater", X2, {"c": np.float32(0.1)}, ["x", "c"], {}, 1),
    "LessOrEqual": ("LessOrEqual", {"x": np.round(_r(5, 6))}, {"c": np.float32(0.0)},
                    ["x", "c"], {}, 1),
    "GreaterOrEqual": ("GreaterOrEqual", {"x": np.round(_r(5, 6))}, {"c": np.float32(1.0)},
                       ["x", "c"], {}, 1),
    "Not": ("Not", {"x": np.random.default_rng(6).random((5, 6)) < 0.5}, {}, ["x"], {}, 1),
    "Expand": ("Expand", {"x": _r(3, 1)}, {"s": _i(2, 1, 4)}, ["x", "s"], {}, 1),
    "CumSum": ("CumSum", X4, {"a": np.int64(2)}, ["x", "a"], {}, 1),
    "LayerNormalization": ("LayerNormalization", X4, {"sc": _r(9, seed=1), "bi": _r(9, seed=2)},
                           ["x", "sc", "bi"], dict(axis=-1, epsilon=1e-5), 1),
    "InstanceNormalization": ("InstanceNormalization", X4,
                              {"sc": _r(3, seed=1), "bi": _r(3, seed=2)},
                              ["x", "sc", "bi"], dict(epsilon=1e-5), 1),
    "Constant": ("Constant", {}, {}, [], dict(value=_r(2, 3)), 1),
    "ConstantOfShape": ("ConstantOfShape", {}, {"s": _i(2, 3)}, ["s"],
                        dict(value=np.asarray([1.5], np.float32)), 1),
    "Range": ("Range", {}, {"a": np.int64(1), "b": np.int64(11), "c": np.int64(3)},
              ["a", "b", "c"], {}, 1),
}


def _graph(op, feeds, inits, inputs, attrs, n_out) -> OnnxGraph:
    outs = [f"y{i}" for i in range(n_out)]
    return OnnxGraph(nodes=[OnnxNode(op, list(inputs), outs, attrs=dict(attrs))],
                     initializers=dict(inits),
                     inputs=[(k, list(v.shape)) for k, v in feeds.items()],
                     outputs=[(o, []) for o in outs])


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op, feeds, inits, inputs, attrs, n_out = CASES[case]
    graph = _graph(op, feeds, inits, inputs, attrs, n_out)
    ref = jax_execute(graph, {k: jnp.asarray(v) for k, v in feeds.items()})
    out = tog.execute(graph, {k: torch.from_numpy(v.copy()) for k, v in feeds.items()})
    assert len(out) == len(ref) == n_out
    for o, r in zip(out, ref):
        assert isinstance(o, torch.Tensor)
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape, (o.shape, r.shape)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(o, r, **TOL)
        else:
            np.testing.assert_array_equal(o, r)


def test_shape_plumbing_stays_numpy():
    """Shape -> Gather -> Concat -> Reshape folds in numpy: the reshape's
    target never becomes a tensor, and initializers are copied to the
    data's device once and kept with the graph."""
    nodes = [OnnxNode("Shape", ["x"], ["s"]),
             OnnxNode("Gather", ["s", "i0"], ["b"], attrs={"axis": 0}),
             OnnxNode("Unsqueeze", ["b", "ax"], ["b1"]),
             OnnxNode("Concat", ["b1", "tail"], ["shape"], attrs={"axis": 0}),
             OnnxNode("Reshape", ["x", "shape"], ["r"]),
             OnnxNode("MatMul", ["r", "w"], ["y"])]
    graph = OnnxGraph(nodes=nodes, initializers={
        "i0": np.int64(0), "ax": _i(0), "tail": _i(-1), "w": _r(12, 2, seed=1)},
        inputs=[("x", [3, 4, 3])], outputs=[("y", [])])
    x = _r(3, 4, 3)
    ref = np.asarray(jax_execute(graph, {"x": jnp.asarray(x)})[0])
    out = tog.execute(graph, {"x": torch.from_numpy(x)})[0]
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    cached = graph._torch_initializers["cpu"]
    assert [v[0] is graph.initializers["w"] for v in cached.values()] == [True]
    fn = tog.compile_graph(graph)
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref, **TOL)


def test_unknown_op_raises():
    graph = _graph("Bogus", X2, {}, ["x"], {}, 1)
    with pytest.raises(NotImplementedError, match="Bogus"):
        tog.execute(graph, {"x": torch.from_numpy(X2["x"])})
