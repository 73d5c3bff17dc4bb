"""The port's layer primitives, rotary and int8-KV ops against the JAX
package, on the CPU, on the same numpy inputs.

Tolerances: float32 results agree to 1e-5 (only the summation order of the
products differs); bf16 results to one bf16 rounding step (2**-7 relative);
int8 quantization is compared bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.models import layers as jl
from moonshine_tpu.ops import int8_kv as jq
from moonshine_tpu.ops import rotary as jr
from moonshine_tpu_torch.models import layers as tl
from moonshine_tpu_torch.ops import int8_kv as tq
from moonshine_tpu_torch.ops import rotary as tr

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _np(x) -> np.ndarray:
    return np.array(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _pair(x: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(x, jnp.float32).astype(jt), torch.from_numpy(x.astype(np.float32)).to(tt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((12, 7)).astype(np.float32) * 0.3
    b = rng.standard_normal(7).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ref = jl.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jx)
    out = tl.dense(tl.Dense(torch.from_numpy(w.T.copy()), torch.from_numpy(b)), tx)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), **(F32 if dtype == "float32" else BF16))


def test_conv1d():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6, 8)).astype(np.float32) * 0.2  # WIO
    b = rng.standard_normal(8).astype(np.float32)
    ref = jl.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), 3)
    conv = tl.Conv1d(torch.from_numpy(w.transpose(2, 1, 0).copy()), torch.from_numpy(b))
    out = tl.conv1d(conv, torch.from_numpy(x), 3)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


@pytest.mark.parametrize("bias", [False, True])
def test_layer_norm(bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(16).astype(np.float32)
    shift = rng.standard_normal(16).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)} | ({"bias": jnp.asarray(shift)} if bias else {})
    tp = tl.Norm(torch.from_numpy(scale), torch.from_numpy(shift) if bias else None)
    ref = jl.layer_norm(jp, jnp.asarray(x))
    out = tl.layer_norm(tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


@pytest.mark.parametrize("masked", [False, True])
def test_group_norm_all(masked):
    rng = np.random.default_rng(3)
    x = np.tanh(rng.standard_normal((3, 11, 8))).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    shift = rng.standard_normal(8).astype(np.float32)
    mask = np.arange(11)[None, :] < np.array([11, 5, 1])[:, None]
    ref = jl.group_norm_all({"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
                            jnp.asarray(x), jnp.asarray(mask) if masked else None)
    out = tl.group_norm_all(tl.Norm(torch.from_numpy(scale), torch.from_numpy(shift)),
                            torch.from_numpy(x), torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu(dtype):
    x = np.linspace(-6, 6, 301).astype(np.float32)
    jx, tx = _pair(x, dtype)
    out = tl.gelu(tx)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(jl.gelu(jx)),
                               **(F32 if dtype == "float32" else BF16))


def test_silu():
    x = np.linspace(-6, 6, 301).astype(np.float32)
    np.testing.assert_allclose(_np(tl.silu(torch.from_numpy(x))), _np(jl.silu(jnp.asarray(x))),
                               **F32)


# -- rotary: partial rotary at Base's hd 52 (46 rotated), Tiny's hd 36 (32) --

HEAD_DIMS = [(52, 46), (36, 32), (16, 14)]


@pytest.mark.parametrize("hd,rot", HEAD_DIMS)
def test_rotary_tables(hd, rot):
    pos = np.array([[0, 1, 5], [7, 100, 383]])
    jc, js = jr.rotary_tables(jnp.asarray(pos), rot, 10000.0)
    tc, ts = tr.rotary_tables(torch.from_numpy(pos), rot, 10000.0)
    assert tc.shape == jc.shape == (2, 3, rot // 2)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(ts), _np(js), atol=2e-5, rtol=0)
    jc2, js2 = jr.fullwidth_tables(jc, js, hd)
    tc2, ts2 = tr.fullwidth_tables(torch.from_numpy(_np(jc)), torch.from_numpy(_np(js)), hd)
    np.testing.assert_array_equal(_np(tc2), _np(jc2))
    np.testing.assert_array_equal(_np(ts2), _np(js2))


@pytest.mark.parametrize("hd,rot", HEAD_DIMS)
def test_pair_swap_perm_and_swap_dense(hd, rot):
    heads = 3
    perm = tr.pair_swap_perm(hd, rot // 2, heads)
    np.testing.assert_array_equal(perm, jr.pair_swap_perm(hd, rot // 2, heads))
    rng = np.random.default_rng(4)
    w = rng.standard_normal((10, hd * heads)).astype(np.float32)
    b = rng.standard_normal(hd * heads).astype(np.float32)
    ref = jr.swap_dense_params({"w": jnp.asarray(w), "b": jnp.asarray(b)}, perm)
    out = tr.swap_dense_params(tl.Dense(torch.from_numpy(w.T.copy()), torch.from_numpy(b)), perm)
    np.testing.assert_array_equal(_np(out.weight).T, _np(ref["w"]))
    np.testing.assert_array_equal(_np(out.bias), _np(ref["b"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,rot", HEAD_DIMS)
def test_apply_rotary_fullwidth(hd, rot, dtype):
    heads, s = 2, 9
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, heads * hd)).astype(np.float32)
    perm = jr.pair_swap_perm(hd, rot // 2, heads)
    xs = x[..., perm]
    cos, sin = jr.rotary_tables(jnp.arange(s), rot, 10000.0)
    jx, tx = _pair(x, dtype)
    jxs, txs = _pair(xs, dtype)
    ref = jr.apply_rotary_fullwidth(jx, jxs, cos, sin, hd, heads)
    out = tr.apply_rotary_fullwidth(tx, txs, torch.from_numpy(_np(cos)),
                                    torch.from_numpy(_np(sin)), hd, heads)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("hd,rot", HEAD_DIMS)
def test_apply_rotary(hd, rot):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 3, hd)).astype(np.float32)  # [B, S, H, hd]
    cos, sin = jr.rotary_tables(jnp.arange(7, 11), rot, 10000.0)
    ref = jr.apply_rotary(jnp.asarray(x), cos, sin)
    out = tr.apply_rotary(torch.from_numpy(x), torch.from_numpy(_np(cos)),
                          torch.from_numpy(_np(sin)))
    np.testing.assert_allclose(_np(out), _np(ref), **F32)
    # Pass-through channels are untouched.
    np.testing.assert_array_equal(_np(out)[..., rot:], x[..., rot:])


# -- int8 KV ---------------------------------------------------------------

def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 16, 10)).astype(np.float32)
    x[0, 0, :, 4] = 0.0  # an all-zero column gets scale 1.0
    x[1, 2, :, 7] = 0.5 * np.sign(x[1, 2, :, 7])  # ties at half steps
    jq8, js = jq.quantize_kv(jnp.asarray(x))
    tq8, ts = tq.quantize_kv(torch.from_numpy(x))
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 4] == 1.0
    np.testing.assert_allclose(tq.dequantize_kv(tq8, ts).numpy(),
                               np.asarray(jq.dequantize_kv(jq8, js)), **F32)


@pytest.mark.parametrize("with_weights", [False, True])
def test_attention_dm_q8(with_weights):
    rng = np.random.default_rng(8)
    b, s, h, hd, t = 2, 3, 4, 16, 13
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, hd, t)).astype(np.float32)
    v = rng.standard_normal((b, h, hd, t)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([13, 6])[:, None])[:, None, None, :]
    jkq, jks = jq.quantize_kv(jnp.asarray(k))
    jvq, jvs = jq.quantize_kv(jnp.asarray(v))
    targs = [torch.from_numpy(np.array(a)) for a in (q, jkq, jks, jvq, jvs, mask)]
    jargs = [jnp.asarray(q), jkq, jks, jvq, jvs, jnp.asarray(mask)]
    if with_weights:
        ref, ref_w = jq.attention_dm_q8_with_weights(*jargs)
        out, out_w = tq.attention_dm_q8_with_weights(*targs)
        np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), **F32)
    else:
        ref = jq.attention_dm_q8(*jargs)
        out = tq.attention_dm_q8(*targs)
    assert out.shape == (b, s, h, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
