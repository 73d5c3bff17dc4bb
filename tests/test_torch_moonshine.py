"""The port's Moonshine model against the JAX package's, on the CPU: the
same JAX-initialised weights (carried across with
``weights.params_from_jax_numpy``) and the same numpy inputs go through
both.  Where the JAX side reaches the Pallas encoder-attention kernel it
runs in interpret mode.

Tolerances: float32 activations agree to atol = rtol = 1e-4 (summation
order differs in every product, compounded over a few layers); greedy
tokens and lengths must be identical; bf16 encodes agree to 0.05, a few
bf16 rounding steps of the layer-normed output.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu.core.config import BASE, MoonshineArchConfig
from moonshine_tpu.decoding.greedy import greedy_decode as jax_greedy
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.models import moonshine as tm

CFG = MoonshineArchConfig(
    name="torch-port-test", vocab_size=64, hidden_size=64, intermediate_size=96,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
F32 = dict(atol=1e-4, rtol=1e-4)

# The JAX side runs jitted: op by op, every lax.scan would compile anew.
_jax_frontend = jax.jit(jm.frontend_apply, static_argnames=("cfg",))
_jax_encode = jax.jit(jm.encode, static_argnames=("cfg", "attn_impl", "interpret"))
_jax_decoder = jax.jit(jm.decoder_apply,
                       static_argnames=("cfg", "collect_cross_attention", "beam_k"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models():
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    return params, weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32), np.array([4000, 2500])


def test_params_round_trip(models):
    params, model = models
    back = weights.params_to_numpy(model)
    ref = jax.tree.map(np.asarray, jm.prepare_rotary_params(params, CFG))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # An F-ordered leaf loads with its values, not its strides.
    tree = jax.tree.map(np.asarray, params)
    w = tree["encoder"]["layers"]["mlp"]["fc1"]["w"]
    tree["encoder"]["layers"]["mlp"]["fc1"]["w"] = np.asfortranarray(w)
    again = weights.params_from_jax_numpy(tree, TCFG, "cpu")
    np.testing.assert_array_equal(_np(again.encoder.layers[1].mlp.fc1.weight), w[1].T)


@pytest.mark.parametrize("stage1", ["space_to_channel", "generic"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_frontend_apply(models, audio, with_lengths, stage1):
    """Stage 1 as a k=2 conv over 64-sample blocks (kernel 127 <= 2 * 64),
    and the generic windowed form, which a stride of 32 forces."""
    params, model = models
    x, lengths = audio
    lj = jnp.asarray(lengths) if with_lengths else None
    lt = _t(lengths) if with_lengths else None
    cfg, tcfg = CFG, TCFG
    if stage1 == "generic":
        cfg = dataclasses.replace(CFG, conv_strides=(32, 3, 2))
        tcfg = dataclasses.replace(TCFG, conv_strides=(32, 3, 2))
    ref_h, ref_m = _jax_frontend(params["frontend"], cfg, jnp.asarray(x), lj)
    out_h, out_m = tm.frontend_apply(model.frontend, tcfg, _t(x), lt)
    assert out_h.shape == ref_h.shape
    np.testing.assert_allclose(_np(out_h), _np(ref_h), **F32)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_encode_auto_matches_pallas_interpret(models, audio, with_lengths):
    params, model = models
    x, lengths = audio
    lj = jnp.asarray(lengths) if with_lengths else None
    ref, ref_m = _jax_encode(params, CFG, jnp.asarray(x), lj, attn_impl="pallas", interpret=True)
    out, out_m = tm.encode(model, TCFG, _t(x), _t(lengths) if with_lengths else None)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))


def test_encode_xla_path_matches_jax_xla(models, audio):
    params, model = models
    x, lengths = audio
    ref, _ = _jax_encode(params, CFG, jnp.asarray(x), jnp.asarray(lengths), attn_impl="xla")
    out, _ = tm.encode(model, TCFG, _t(x), _t(lengths), attn_impl="xla")
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


@pytest.mark.parametrize("kv_heads,attn_impl", [(2, "auto"), (4, "packed")])
def test_encode_rejects_what_the_packed_path_cannot_take(models, audio, kv_heads, attn_impl):
    """"auto" is always the packed attention, which has no GQA form; the
    only other value is "xla"."""
    _, model = models
    x, _ = audio
    cfg = dataclasses.replace(TCFG, encoder_kv_heads=kv_heads)
    with pytest.raises(ValueError, match="kv_heads" if attn_impl == "auto" else "attn_impl"):
        tm.encode(model, cfg, _t(x), attn_impl=attn_impl)


def test_encode_bf16(models, audio):
    """bf16 weights and activations; the two attention paths round at
    different places, so the tolerance is bf16's."""
    params, model = models
    x, lengths = audio
    pb = jm.prepare_rotary_params(jax.tree.map(lambda a: a.astype(jnp.bfloat16), params), CFG)
    ref, _ = _jax_encode(pb, CFG, jnp.asarray(x), jnp.asarray(lengths), attn_impl="pallas",
                       interpret=True)
    mb = weights.params_from_jax_numpy(jax.tree.map(np.asarray, pb), TCFG, "cpu")
    out, _ = tm.encode(mb, TCFG, _t(x), _t(lengths))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), atol=0.05, rtol=0.05)


def _memory(seed=1, b=2, t=11):
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((b, t, CFG.hidden_size)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 6, 3][:b])[:, None]
    return memory, mask


def _caches(params, model, memory, mask, batch, max_len, kv_int8):
    jk, jv = jm.compute_cross_kv(params["decoder"], CFG, jnp.asarray(memory))
    tk, tv = tm.compute_cross_kv(model.decoder, TCFG, _t(memory))
    jc = jm.init_cache(CFG, batch, max_len, jk, jv, jnp.asarray(mask), kv_int8=kv_int8)
    tc = tm.init_cache(TCFG, batch, max_len, tk, tv, _t(mask), kv_int8=kv_int8)
    return jc, tc


def _assert_caches_equal(tc, jc, exact_int8=True):
    assert tc.cur_len == int(jc.cur_len)
    for name in tm.DecoderCache._fields:
        a, b = getattr(tc, name), getattr(jc, name)
        if name == "cur_len" or a is None:
            assert b is None or name == "cur_len"
            continue
        assert tuple(a.shape) == tuple(b.shape), name
        if a.dtype == torch.int8:
            if exact_int8:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
            else:  # a rounding tie may land on the other side
                assert np.abs(a.numpy().astype(int) - np.asarray(b).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **F32)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_cross_kv_and_init_cache(models, kv_int8):
    params, model = models
    memory, mask = _memory()
    jc, tc = _caches(params, model, memory, mask, 2, 7, kv_int8)
    assert tuple(tc.k_cross.shape) == (2, 2, 4, 16, 11)  # [L, B, H, hd, T]
    _assert_caches_equal(tc, jc, exact_int8=False)


@pytest.mark.parametrize("variant", ["plain", "token_mask", "cross_attention", "beam_k",
                                     "int8"])
def test_decoder_apply(models, variant):
    params, model = models
    memory, mask = _memory()
    rng = np.random.default_rng(2)
    beam_k = 2 if variant == "beam_k" else 1
    batch = 2 * beam_k
    jc, tc = _caches(params, model, memory, mask, batch, 8, variant == "int8")
    tokens = rng.integers(3, CFG.vocab_size, (batch, 3))
    token_mask = np.array([[1, 1, 0], [1, 0, 0]], bool) if variant == "token_mask" else None
    collect = variant == "cross_attention"
    kw = dict(collect_cross_attention=collect, beam_k=beam_k)
    jl, jc, jw = _jax_decoder(params["decoder"], CFG, jnp.asarray(tokens), jc,
                                  None if token_mask is None else jnp.asarray(token_mask), **kw)
    tl, tc, tw = tm.decoder_apply(model.decoder, TCFG, _t(tokens), tc,
                                  None if token_mask is None else _t(token_mask), **kw)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (batch, 3, CFG.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    _assert_caches_equal(tc, jc, exact_int8=False)
    if collect:
        assert tuple(tw.shape) == (2, 2, 4, 3, 11)  # [L, B, H, s, T]
        np.testing.assert_allclose(_np(tw), _np(jw), **F32)
    # One more step reads what the first wrote.
    nxt = rng.integers(3, CFG.vocab_size, (batch, 1))
    jl, jc, _ = _jax_decoder(params["decoder"], CFG, jnp.asarray(nxt), jc, beam_k=beam_k)
    tl, tc, _ = tm.decoder_apply(model.decoder, TCFG, _t(nxt), tc, beam_k=beam_k)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    assert tc.cur_len == 4


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_tokens_match_jax(models, kv_int8):
    params, model = models
    memory, mask = _memory(seed=3, b=3)
    caps = np.array([7, 3, 0])
    ref = jax_greedy(params, CFG, jnp.asarray(memory), jnp.asarray(mask), max_tokens=9,
                     token_caps=jnp.asarray(caps), kv_int8=kv_int8)
    out = greedy_decode(model, TCFG, _t(memory), _t(mask), max_tokens=9,
                        token_caps=_t(caps), kv_int8=kv_int8)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    assert out.lengths[2] == 0 and out.lengths.max() > 0


@pytest.mark.parametrize("cfg_name", ["tiny", "base"])
def test_host_frame_math(cfg_name):
    from moonshine_tpu.core.config import ARCHS as JARCHS
    from moonshine_tpu_torch.core.config import ARCHS as TARCHS

    jc, tc = JARCHS[cfg_name], TARCHS[cfg_name]
    for n in (0, 1000, 16000, 32000, 148160, 160000 + 17):
        assert tm.frames_for_samples(tc, n) == jm.frames_for_samples(jc, n)
        assert tm.lane_aligned_samples(tc, n) == jm.lane_aligned_samples(jc, n)


@pytest.fixture(scope="module")
def base_entry():
    import __graft_entry__

    fn, (params, audio, tokens) = __graft_entry__.entry()
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), tm_base(), "cpu")
    return fn, params, model, np.asarray(audio), np.asarray(tokens)


def tm_base():
    from moonshine_tpu_torch.core.config import BASE as TBASE

    return TBASE


def _port_forward(model, audio, tokens):
    """The port's counterpart of ``__graft_entry__.entry()``'s forward."""
    cfg = tm_base()
    memory, frame_mask = tm.encode(model, cfg, audio)
    k_cross, v_cross = tm.compute_cross_kv(model.decoder, cfg, memory)
    cache = tm.init_cache(cfg, audio.shape[0], tokens.shape[1], k_cross, v_cross, frame_mask,
                          dtype=memory.dtype)
    logits, _, _ = tm.decoder_apply(model.decoder, cfg, tokens, cache)
    return logits


@pytest.mark.parametrize("audio_kind", ["entry", "noise"])
def test_graft_entry_base_forward(base_entry, audio_kind):
    """The flagship forward (encode + one teacher-forced decoder pass) on
    BASE at full width: JAX logits against the port's, float32, atol 2e-4
    on logits of order 0.1-1 (eight layers each way)."""
    fn, params, model, audio, tokens = base_entry
    assert BASE.hidden_size == 416 and BASE.encoder_layers == 8
    if audio_kind == "noise":
        audio = (np.random.default_rng(4).standard_normal(audio.shape) * 0.1).astype(np.float32)
        tokens = np.random.default_rng(5).integers(3, BASE.vocab_size, tokens.shape)
    ref = jax.jit(fn)(params, jnp.asarray(audio), jnp.asarray(tokens))
    with torch.inference_mode():
        out = _port_forward(model, _t(audio), _t(tokens))
    assert tuple(out.shape) == tuple(ref.shape) == (2, 16, BASE.vocab_size)
    assert np.isfinite(_np(out)).all()
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-4, rtol=1e-3)
