"""The port's TFLite executor (``ops/tflite_graph.py``) and its copy of the
flatbuffer reader (``core/tflite_io.py``) against the JAX package's, on the
CPU, on in-memory graphs with seeded numpy weights.

- Every op the executor has, one graph each: CONV_2D at both paddings,
  strides 1 and 2 (XLA's uneven SAME padding) and a dilation, with each
  fused activation; TRANSPOSE_CONV at strides 1, 2 and 4 with even and odd
  kernels at both paddings; FULLY_CONNECTED; exact and tanh GELU; ADD and
  MUL by constants; TRANSPOSE; RESHAPE from an operand and from its
  option, with the batch substituted.  Outputs to atol = rtol = 1e-5
  (float32 sums of at most a few hundred products in another order).
- ``conv_transpose_padding`` equals ``lax``'s rule; ``_dequant`` equals
  JAX's exactly (int8 per-channel, int16 and int64 per-tensor, int32
  operands passed through).
- The pack decoder's contract graph (``chip_smoke.pack_decoder_graph``):
  ten tiles in one batch against JAX's executor, and each tile alone
  equal to its row of the batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax.convolution import _conv_transpose_padding

from torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import PACK_LATENT_DIM, PACK_TILE, pack_decoder_graph
from moonshine_tpu.core import tflite_io as jio
from moonshine_tpu.ops import tflite_graph as jtg
from moonshine_tpu_torch.core.tflite_io import (BUILTIN_NAMES, TfliteModel, TfliteOp,
                                                TfliteTensor, parse_tflite)
from moonshine_tpu_torch.ops import tflite_graph as ttg

TOL = dict(atol=1e-5, rtol=1e-5)


def _graph(op: str, x_shape, consts, options, extra_ins=(), weight_first=False) -> TfliteModel:
    """One op over input 0 and constant operands ``consts`` ((array, scale,
    qdim) each); ``weight_first``: TRANSPOSE_CONV's operand order."""
    tensors = [TfliteTensor("x", tuple(x_shape), np.dtype(np.float32), None, None, None)]
    ids = []
    for arr, scale, qdim in consts:
        tensors.append(TfliteTensor(f"c{len(tensors)}", arr.shape, arr.dtype, arr,
                                    None if scale is None else np.asarray(scale, np.float32),
                                    None, qdim))
        ids.append(len(tensors) - 1)
    tensors.append(TfliteTensor("y", (), np.dtype(np.float32), None, None, None))
    ins = ([ids[0], ids[1], 0, *ids[2:]] if weight_first else [0, *ids]) + list(extra_ins)
    return TfliteModel(tensors=tensors, ops=[TfliteOp(op, ins, [len(tensors) - 1], options)],
                       inputs=[0], outputs=[len(tensors) - 1])


def _run_both(model: TfliteModel, x: np.ndarray):
    ref = np.asarray(jax.jit(jtg.TfliteExecutor(model).run)(jnp.asarray(x)))
    ours = ttg.TfliteExecutor(model, "cpu").run(torch.from_numpy(x)).numpy()
    return ours, ref


def _weights(rng, shape, per_channel: bool):
    q = rng.integers(-127, 128, shape).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, shape[0] if per_channel else 1) / (127.0 * np.sqrt(
        np.prod(shape[1:])))
    return q, scale, 0


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride,dilation,kernel", [(1, 1, (3, 3)), (2, 1, (3, 3)),
                                                    (2, 1, (1, 4)), (1, 2, (3, 2))])
@pytest.mark.parametrize("act", [0, 1, 3])
def test_conv_2d(padding, stride, dilation, kernel, act):
    rng = np.random.default_rng(stride * 10 + dilation + kernel[1] + act)
    x = rng.standard_normal((2, 7, 10, 5)).astype(np.float32) * 3.0
    w = _weights(rng, (6, *kernel, 5), per_channel=True)
    b = (rng.integers(-500, 500, 6).astype(np.int64), [1e-3], 0)
    model = _graph("CONV_2D", x.shape, [w, b], dict(
        padding=padding, stride_h=stride, stride_w=stride, dilation_h=dilation,
        dilation_w=dilation, fused_activation=act))
    ours, ref = _run_both(model, x)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("kernel", [(1, 3), (2, 4), (3, 3), (1, 8)])
def test_transpose_conv(padding, stride, kernel):
    rng = np.random.default_rng(stride * 100 + kernel[0] * 10 + kernel[1] + padding)
    x = rng.standard_normal((2, 3, 6, 5)).astype(np.float32)
    # As JAX reads TRANSPOSE_CONV: the weights' axis 0 is x's channels.
    w = _weights(rng, (5, *kernel, 7), per_channel=False)
    shape = (np.asarray([2, 3 * stride, 6 * stride, 7], np.int32), None, 0)
    b = ((rng.standard_normal(7) * 0.1).astype(np.float32), None, 0)
    model = _graph("TRANSPOSE_CONV", x.shape, [shape, w, b],
                   dict(padding=padding, stride_h=stride, stride_w=stride), weight_first=True)
    ours, ref = _run_both(model, x)
    assert ours.shape == ref.shape
    if padding == 0:
        assert ours.shape == (2, 3 * stride, 6 * stride, 7)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_conv_transpose_padding_is_lax_rule():
    for k in range(1, 9):
        for s in range(1, 5):
            for pad in ("SAME", "VALID"):
                assert ttg.conv_transpose_padding(k, s, pad) == tuple(
                    _conv_transpose_padding(k, s, pad)), (k, s, pad)


@pytest.mark.parametrize("act,bias", [(0, True), (1, False), (3, True)])
def test_fully_connected(act, bias):
    rng = np.random.default_rng(act)
    x = rng.standard_normal((3, 4, 24)).astype(np.float32) * 4.0
    consts = [_weights(rng, (16, 24), per_channel=True)]
    if bias:
        consts.append((rng.integers(-900, 900, 16).astype(np.int64), [1e-3], 0))
    ours, ref = _run_both(_graph("FULLY_CONNECTED", x.shape, consts,
                                 dict(fused_activation=act)), x)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("approximate", [0, 1])
def test_gelu(approximate):
    x = np.linspace(-6, 6, 2 * 3 * 41, dtype=np.float32).reshape(2, 3, 41)
    ours, ref = _run_both(_graph("GELU", x.shape, [], dict(approximate=approximate)), x)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("op", ["ADD", "MUL"])
def test_add_mul_constants(op):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8)).astype(np.float32)
    c = (rng.integers(-3000, 3000, 8).astype(np.int16), [1.0 / 1024], 0)
    ours, ref = _run_both(_graph(op, x.shape, [c], {}), x)
    np.testing.assert_array_equal(ours, ref)


def test_transpose_and_reshape_with_batch():
    x = np.arange(3 * 4 * 6, dtype=np.float32).reshape(3, 4, 6)
    perm = (np.asarray([0, 2, 1], np.int32), None, 0)
    ours, ref = _run_both(_graph("TRANSPOSE", x.shape, [perm], {}), x)
    np.testing.assert_array_equal(ours, ref)
    # the graph declares batch 1; a batch of 3 is substituted into both forms
    shape = (np.asarray([1, 2, 12], np.int32), None, 0)
    ours, ref = _run_both(_graph("RESHAPE", (1, 4, 6), [shape], {}), x)
    assert ours.shape == ref.shape == (3, 2, 12)
    np.testing.assert_array_equal(ours, ref)
    ours, ref = _run_both(_graph("RESHAPE", (1, 4, 6), [], {"new_shape": [1, 24]},
                                 extra_ins=[-1]), x)
    assert ours.shape == (3, 24)
    np.testing.assert_array_equal(ours, ref)


def test_batched_ops_that_move_axis_0_raise():
    x = np.zeros((2, 4, 6), np.float32)
    model = _graph("TRANSPOSE", x.shape, [(np.asarray([1, 0, 2], np.int32), None, 0)], {})
    with pytest.raises(NotImplementedError, match="axis 0"):
        ttg.TfliteExecutor(model, "cpu").run(torch.from_numpy(x))
    model = _graph("RESHAPE", x.shape, [(np.asarray([4, 6], np.int32), None, 0)], {})
    with pytest.raises(NotImplementedError, match="axis 0"):
        ttg.TfliteExecutor(model, "cpu").run(torch.from_numpy(x))


def test_dequant_is_jax_dequant():
    rng = np.random.default_rng(6)
    cases = [
        TfliteTensor("w", (4, 1, 3, 2), np.dtype(np.int8),
                     rng.integers(-127, 128, (4, 1, 3, 2)).astype(np.int8),
                     rng.uniform(0.01, 0.1, 4).astype(np.float32), None, 0),
        TfliteTensor("b", (4,), np.dtype(np.int64), rng.integers(-9, 9, 4).astype(np.int64),
                     np.asarray([1e-4], np.float32), None, 0),
        TfliteTensor("c", (5,), np.dtype(np.int16), rng.integers(-99, 99, 5).astype(np.int16),
                     np.asarray([2e-3], np.float32), None, 0),
        TfliteTensor("shape", (3,), np.dtype(np.int32), np.asarray([1, 2, 3], np.int32),
                     None, None, 0),
        TfliteTensor("f", (2,), np.dtype(np.float32), np.asarray([0.5, -1.0], np.float32),
                     None, None, 0),
    ]
    for t in cases:
        ours, ref = ttg._dequant(t), jtg._dequant(t)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="no constant data"):
        ttg._dequant(TfliteTensor("x", (1,), np.dtype(np.float32), None, None, None))


def test_reader_refuses_what_jax_refuses():
    for blob in (b"", b"\x00" * 8, b"\x10\x00\x00\x00TFL2" + b"\x00" * 16):
        with pytest.raises(ValueError, match="TFL3"):
            parse_tflite(blob)
        with pytest.raises(ValueError, match="TFL3"):
            jio.parse_tflite(blob)
    assert BUILTIN_NAMES == jio.BUILTIN_NAMES


def test_pack_decoder_graph_batched_matches_jax():
    model = pack_decoder_graph()
    tiles = np.random.default_rng(7).standard_normal((10, PACK_TILE, PACK_LATENT_DIM)).astype(
        np.float32)
    ours, ref = _run_both(model, tiles)
    assert ours.shape == ref.shape == (10, 4 * PACK_TILE, 60)
    np.testing.assert_allclose(ours, ref, **TOL)
    ex = ttg.TfliteExecutor(model, "cpu")
    for i in (0, 9):
        np.testing.assert_allclose(ex.run(torch.from_numpy(tiles[i:i + 1])).numpy()[0], ours[i],
                                   **TOL)
