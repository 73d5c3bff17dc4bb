"""The port's int8 quantization and w8a8 execution against the JAX
package's, on the CPU, with the same weights and inputs.

Exact where the arithmetic is the same: the exec-quantized leaves, the
numpy trees, the int8 activations, their scales and the int32
accumulators are bit-equal.  Float32 logits of a w8a8 model agree to
atol = rtol = 1e-4 (tests/test_torch_moonshine.py's float32 tolerance:
the float operations between the int8 products sum in another order);
greedy tokens must be identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu import quant as jquant
from moonshine_tpu.core.config import MoonshineArchConfig, StreamingConfig
from moonshine_tpu.decoding.greedy import greedy_decode as jax_greedy
from moonshine_tpu.models import layers as jlayers
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu.models import streaming as jms
from moonshine_tpu.weights import export_streaming_state_dict as jax_export_streaming
from moonshine_tpu_torch import quant, weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.eval.quant_eval import compare_decodes
from moonshine_tpu_torch.models import layers as tlayers
from moonshine_tpu_torch.models import moonshine as tm
from moonshine_tpu_torch.models import streaming as tms

# Base's head shape (head_dim 52, rotary over 46 channels) at a small width.
CFG = MoonshineArchConfig(
    name="torch-quant-test", vocab_size=64, hidden_size=104, intermediate_size=208,
    encoder_layers=2, decoder_layers=2, encoder_heads=2, decoder_heads=2,
    encoder_kv_heads=2, decoder_kv_heads=2,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
SCFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16, vocab_size=128,
    d_model_frontend=32, c1=48, c2=64, max_seq_len=64, encoder_depth=2,
)
TSCFG = TorchStreamingConfig(**{f: getattr(SCFG, f) for f in SCFG.__dataclass_fields__})
F32 = dict(atol=1e-4, rtol=1e-4)

_jax_encode = jax.jit(jm.encode, static_argnames=("cfg", "attn_impl", "interpret"))
_jax_decoder = jax.jit(jm.decoder_apply,
                       static_argnames=("cfg", "collect_cross_attention", "beam_k"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def params():
    # Larger weights than the initializer's make the random model emit a
    # few tokens before EOS.
    p = jm.init_params(CFG, jax.random.PRNGKey(3))
    return jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a, p)


@pytest.fixture(scope="module")
def models(params):
    """(JAX exec-quantized tree, the port's exec-quantized model)."""
    jq = jquant.quantize_tree_exec(jm.prepare_rotary_params(params, CFG))
    tq = quant.quantize_tree_exec(weights.params_from_jax_numpy(_np_tree(params), TCFG, "cpu"))
    return jq, tq


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 6000)) * 0.1).astype(np.float32), np.array([6000, 4200])


# -- trees -----------------------------------------------------------------

def test_quantize_tree_exec_leaves_bit_equal(params, models):
    jq, tq = models
    _assert_trees_equal(weights.params_to_numpy(tq), _np_tree(jq))
    assert tq.decoder.embed.dtype == torch.float32  # embed stays float
    assert tq.frontend.conv2.weight.dtype == torch.float32  # the frontend stays float
    # Rotary preparation and quantization commute, as in JAX: quantize
    # first, then build the pair-swapped projections from w_q / w_scale.
    bare = weights.params_from_jax_numpy(_np_tree(params), TCFG, "cpu")
    for layer in bare.encoder.layers:
        layer.attn.q_swapped = layer.attn.k_swapped = None
    later = tm.prepare_rotary_params(quant.quantize_tree_exec(bare), TCFG)
    _assert_trees_equal(weights.params_to_numpy(later), _np_tree(jq))
    # A JAX exec-quantized tree carries across as it is.
    carried = weights.params_from_jax_numpy(_np_tree(jq), TCFG, "cpu")
    assert carried.encoder.layers[0].attn.q.w_q.dtype == torch.int8
    _assert_trees_equal(weights.params_to_numpy(carried), _np_tree(jq))


def test_numpy_trees_equal_jax(params):
    tree = _np_tree(params)
    packed = quant.quantize_tree(tree)
    _assert_trees_equal(packed, _np_tree(jquant.quantize_tree(params)))
    _assert_trees_equal(quant.dequantize_tree(packed),
                        _np_tree(jquant.dequantize_tree(jquant.quantize_tree(params))))
    for per_channel in (True, False):
        _assert_trees_equal(quant.fake_quantize_tree(tree, per_channel=per_channel),
                            _np_tree(jquant.fake_quantize_tree(params, per_channel=per_channel)))
    assert quant.tree_nbytes(packed) == jquant.tree_nbytes(jquant.quantize_tree(params))
    assert quant.tree_nbytes(tree) == jquant.tree_nbytes(params)


# -- the w8a8 product ------------------------------------------------------

def _jax_w8a8_parts(p, x):
    """``layers._dense_w8a8`` of the JAX package, line for line, returning
    its intermediates."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    s_x = jnp.maximum(amax, 1e-12) / 127.0
    x_q = jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, p["w_q"], (((x_q.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * s_x * p["w_scale"]
    if "b" in p:
        y = y + p["b"]
    return x_q, s_x, acc, y.astype(x.dtype)


def _activations(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    # Rounding ties: a row whose amax is 127 has s_x = 1 exactly, and its
    # .5 values must round half to even in both frameworks.
    x.reshape(-1, shape[-1])[0, :4] = [127.0, 2.5, -3.5, 0.5]
    return x


@pytest.mark.parametrize("shape", [(2, 5, 104), (1, 1, 104), (3, 208)],
                         ids=["B2xS5", "B1xS1-row-padding", "rows3-fc2"])
def test_w8a8_intermediates_bit_equal(models, shape):
    jq, tq = models
    name = "fc1" if shape[-1] == 104 else "fc2"
    jp = jax.tree.map(lambda a: a[1], jq["encoder"]["layers"]["mlp"][name])
    tp = getattr(tq.encoder.layers[1].mlp, name)
    x = _activations(shape, 1)
    jx_q, js_x, jacc, jy = jax.jit(_jax_w8a8_parts)(jp, jnp.asarray(x))
    # The helper is the JAX package's computation: it gives dense's bits.
    np.testing.assert_array_equal(np.asarray(jy), np.asarray(jax.jit(jlayers.dense)(jp, x)))
    x_q, s_x = tlayers.quantize_rows(torch.from_numpy(x))
    acc = tlayers.int8_matmul(x_q, tp.w_q)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(s_x.numpy(), np.asarray(js_x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tlayers.dense(tp, torch.from_numpy(x)).numpy(), np.asarray(jy),
                               rtol=1e-6, atol=1e-6)
    # The ties rounded half to even.
    assert x_q.reshape(-1, shape[-1])[0, :4].tolist() == [127, 2, -4, 0]


@pytest.mark.parametrize("m,k,n", [(1, 104, 208), (16, 104, 8), (17, 104, 8), (3, 12, 10)])
def test_int8_matmul_pads_exactly(m, k, n):
    """Rows below 17 (the B=1 decode's one row) and a contraction or output
    width off the multiple of 8 are padded with zeros: the int32 result is
    the exact product, on the plain CPU twin of the CUDA path."""
    rng = np.random.default_rng(m * 100 + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    out = tlayers.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert out.dtype == torch.int32 and tuple(out.shape) == (m, n)
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def test_int8_matmul_gives_the_card_its_layouts(models, monkeypatch):
    """cuBLASLt's int8 product (torch._int_mm on CUDA) takes a row-major
    activation matrix and a column-major weight and refuses other layouts;
    the CPU's takes any.  Every product of a w8a8 encode and decode step is
    handed the card's layouts, the encoder's transposed first input
    included."""
    _, tq = models
    real, calls = torch._int_mm, []

    def checked(a, b):
        assert a.is_contiguous() and b.t().is_contiguous(), (a.stride(), b.stride())
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        calls.append(a.shape)
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", checked)
    # 1 s gives 41 frames, more than 16 rows, so no padding makes them
    # row-major on the way.
    x = (np.random.default_rng(5).standard_normal((1, 16000)) * 0.1).astype(np.float32)
    with torch.inference_mode():
        mem, mask = tm.encode(tq, TCFG, torch.from_numpy(x), torch.tensor([16000]))
        greedy_decode(tq, TCFG, mem, mask, max_tokens=2)
    assert mem.shape[1] > 16 and len(calls) > 8 * TCFG.encoder_layers


# -- the model -------------------------------------------------------------

def test_w8a8_logits_match_jax(models, audio):
    jq, tq = models
    x, lengths = audio
    jmem, jmask = _jax_encode(jq, CFG, jnp.asarray(x), jnp.asarray(lengths), attn_impl="xla")
    with torch.inference_mode():
        tmem, tmask = tm.encode(tq, TCFG, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **F32)
    tokens = np.array([[1, 5, 9, 17], [1, 7, 3, 2]])
    jk, jv = jm.compute_cross_kv(jq["decoder"], CFG, jmem)
    jcache = jm.init_cache(CFG, 2, 8, jk, jv, jmask)
    jlogits, _, _ = _jax_decoder(jq["decoder"], CFG, jnp.asarray(tokens, jnp.int32), jcache)
    with torch.inference_mode():
        tk, tv = tm.compute_cross_kv(tq.decoder, TCFG, torch.from_numpy(np.array(jmem)))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)
        tcache = tm.init_cache(TCFG, 2, 8, tk, tv, torch.from_numpy(np.array(jmask)))
        tlogits, _, _ = tm.decoder_apply(tq.decoder, TCFG, torch.from_numpy(tokens), tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)


@pytest.mark.parametrize("kind", ["exec", "fake"])
@pytest.mark.parametrize("batch", [2, 1])
def test_w8a8_greedy_tokens_equal_jax(params, models, audio, kind, batch):
    """Greedy tokens of exec-quantized (w8a8) and fake-quantized (float
    weights on the int8 grid) models equal JAX's; B=1 runs every int8
    product of the decode on one row, through the row padding."""
    if kind == "exec":
        jp, tp = models
    else:
        jp = jquant.fake_quantize_tree(params)
        tp = weights.params_from_jax_numpy(quant.fake_quantize_tree(_np_tree(params)), TCFG, "cpu")
    x, lengths = audio[0][:batch], audio[1][:batch]
    jmem, jmask = _jax_encode(jp, CFG, jnp.asarray(x), jnp.asarray(lengths), attn_impl="xla")
    ref = jax_greedy(jp, CFG, jmem, jmask, max_tokens=12)
    with torch.inference_mode():
        tmem, tmask = tm.encode(tp, TCFG, torch.from_numpy(x), torch.from_numpy(lengths))
        out = greedy_decode(tp, TCFG, tmem, tmask, max_tokens=12)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert int(out.lengths.max()) > 0, "the random model should emit some tokens"


def test_quantized_streaming_decode_matches_jax():
    """After tests/test_quant.py's streaming case: fake-quantized streaming
    weights (and, port against JAX, exec-quantized ones) decode the same
    tokens."""
    jp = jms.init_params(SCFG, jax.random.PRNGKey(1))
    tp = weights.import_streaming(jax_export_streaming(jp, SCFG), TSCFG, device="cpu")
    chunk = (np.random.RandomState(0).randn(20 * 80) * 0.1).astype(np.float32)
    for jparams, tmodel in (
            (jquant.fake_quantize_tree(jp),
             weights.import_streaming(jax_export_streaming(
                 jquant.fake_quantize_tree(jp), SCFG), TSCFG, device="cpu")),
            (jquant.quantize_tree_exec(jp), quant.quantize_tree_exec(tp))):
        js = jms.frontend_step(jparams, SCFG, jnp.asarray(chunk), jms.init_state(SCFG))
        js, jn = jms.encode(jparams, SCFG, js, is_final=True)
        ref, _ = jms.decode_full(jparams, SCFG, js, max_tokens=8)
        ts = tms.frontend_step(tmodel, TSCFG, torch.from_numpy(chunk),
                               tms.init_state(TSCFG, device="cpu"))
        ts, tn = tms.encode(tmodel, TSCFG, ts, is_final=True)
        out, _ = tms.decode_full(tmodel, TSCFG, ts, max_tokens=8)
        assert tn == jn == 20
        assert out == ref


def test_quant_eval_harness_runs_on_cpu():
    out = compare_decodes(arch="tiny", n_clips=2, seconds=1.5, w8a8=True, device="cpu")
    assert out["device"] == "cpu" and out["size_ratio"] < 0.45
    assert 0.0 <= out["w8a8_token_agreement"] <= 1.0
    from moonshine_tpu.core.config import ARCHS

    jparams = jm.init_params(ARCHS["tiny"], jax.random.PRNGKey(0))
    assert out["fp32_bytes"] == jquant.tree_nbytes(jparams)
    assert out["int8_bytes"] == jquant.tree_nbytes(jquant.quantize_tree(jparams))
