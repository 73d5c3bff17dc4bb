"""The port's speculative decoding against the JAX package's, on the CPU:
the same JAX-initialised weights (carried across with
``weights.params_from_jax_numpy``) and the same encoder memories go through
``speculative_decode`` / ``speculative_decode_batched`` of both packages,
on the cases of ``tests/test_speculative.py``.

Tolerance: none.  Tokens, lengths, accepted draft tokens and rounds (verify
calls) must be equal, and the tokens equal the verifier's greedy decode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.decoding import speculative as jspec
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.decoding import speculative as spec
from moonshine_tpu_torch.decoding.greedy import greedy_decode

# The verify and draft configs of tests/test_speculative.py.
VERIFY_CFG = MoonshineArchConfig(
    name="verify", vocab_size=128, hidden_size=64, intermediate_size=128,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
DRAFT_CFG = MoonshineArchConfig(
    name="draft", vocab_size=128, hidden_size=32, intermediate_size=64,
    encoder_layers=1, decoder_layers=1, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)


def _tcfg(cfg):
    return TorchArchConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


TVERIFY, TDRAFT = _tcfg(VERIFY_CFG), _tcfg(DRAFT_CFG)
_encode = jax.jit(jm.encode, static_argnames=("cfg",))
_jax_apply_vec = jax.jit(jspec._decoder_apply_vec, static_argnames=("cfg",))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models():
    vparams = jm.init_params(VERIFY_CFG, jax.random.PRNGKey(0))
    dparams = jm.init_params(DRAFT_CFG, jax.random.PRNGKey(1))
    tv = weights.params_from_jax_numpy(jax.tree.map(np.asarray, vparams), TVERIFY, "cpu")
    td = weights.params_from_jax_numpy(jax.tree.map(np.asarray, dparams), TDRAFT, "cpu")
    return vparams, dparams, tv, td


def _memories(models, seed, b, n, lengths=None):
    """Both models' encoder memories of the same audio, as numpy arrays."""
    vparams, dparams, _, _ = models
    audio = jnp.asarray(np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)
                        * 0.1)
    lj = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    v = _encode(vparams, VERIFY_CFG, audio, lj)
    d = _encode(dparams, DRAFT_CFG, audio, lj)
    return [np.asarray(x) for x in (*d, *v)]  # d_mem, d_mask, v_mem, v_mask


@pytest.fixture(scope="module")
def single(models):
    return _memories(models, 0, 1, 4000)


def _pair(models, self_draft):
    vparams, dparams, tv, td = models
    if self_draft:
        return (vparams, VERIFY_CFG, tv, TVERIFY)
    return (dparams, DRAFT_CFG, td, TDRAFT)


def _assert_single_equal(out, ref):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert int(out.length) == int(ref.length)
    assert int(out.accepted_draft_tokens) == int(ref.accepted_draft_tokens)
    assert out.verify_calls == int(ref.verify_calls)


@pytest.mark.parametrize("gamma,self_draft", [(1, False), (2, False), (3, False), (4, False),
                                              (7, False), (4, True)])
def test_single_matches_jax(models, single, gamma, self_draft):
    vparams, _, tv, _ = models
    djp, dcfg, dtp, dtcfg = _pair(models, self_draft)
    d_mem, d_mask, v_mem, v_mask = single
    if self_draft:
        d_mem, d_mask = v_mem, v_mask
    ref = jspec.speculative_decode(djp, dcfg, vparams, VERIFY_CFG, *map(jnp.asarray, (
        d_mem, d_mask, v_mem, v_mask)), gamma=gamma, max_tokens=16)
    out = spec.speculative_decode(dtp, dtcfg, tv, TVERIFY, *map(_t, (d_mem, d_mask, v_mem, v_mask)),
                                  gamma=gamma, max_tokens=16)
    _assert_single_equal(out, ref)
    g = greedy_decode(tv, TVERIFY, _t(v_mem), _t(v_mask), max_tokens=16)
    np.testing.assert_array_equal(out.tokens.numpy(), g.tokens[0].numpy())
    assert int(out.length) == int(g.lengths[0])
    # Every emitted token is an accepted draft token or a correction (at most
    # one per verify call); a self-draft accepts everything.
    assert int(out.length) <= int(out.accepted_draft_tokens) + out.verify_calls
    if self_draft:
        assert out.verify_calls <= -(-int(out.length) // gamma) + 1


@pytest.mark.parametrize("gamma,self_draft,kv_int8,caps,lengths", [
    (2, False, False, None, [6000, 4000, 2500]),
    (4, False, False, None, [6000, 4000, 2500]),
    (4, True, False, None, None),
    (4, False, True, None, None),
    (3, True, True, None, [6000, 3100, 2200]),
    (4, False, False, [3, 9, 0], None),
    (7, False, True, [16, 2, 11], [6000, 4000, 2500]),
])
def test_batched_matches_jax(models, gamma, self_draft, kv_int8, caps, lengths):
    """B=3 lanes (different audio lengths where ``lengths`` is set): the
    port's batched result equals JAX's in every field."""
    vparams, _, tv, _ = models
    djp, dcfg, dtp, dtcfg = _pair(models, self_draft)
    d_mem, d_mask, v_mem, v_mask = _memories(models, 2, 3, 6000, lengths)
    if self_draft:
        d_mem, d_mask = v_mem, v_mask
    ref = jspec.speculative_decode_batched(
        djp, dcfg, vparams, VERIFY_CFG, *map(jnp.asarray, (d_mem, d_mask, v_mem, v_mask)),
        gamma=gamma, max_tokens=16, kv_int8=kv_int8,
        token_caps=None if caps is None else jnp.asarray(caps, jnp.int32))
    out = spec.speculative_decode_batched(
        dtp, dtcfg, tv, TVERIFY, *map(_t, (d_mem, d_mask, v_mem, v_mask)), gamma=gamma,
        max_tokens=16, kv_int8=kv_int8, token_caps=None if caps is None else _t(caps))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.accepted_draft_tokens.numpy(),
                                  np.asarray(ref.accepted_draft_tokens))
    assert out.rounds == int(ref.rounds)
    if caps is not None:
        assert (out.lengths.numpy() <= np.asarray(caps)).all()
    if not kv_int8:
        # Float caches: each lane is the verifier's own greedy decode.
        g = greedy_decode(tv, TVERIFY, _t(v_mem), _t(v_mask), max_tokens=16,
                          token_caps=None if caps is None else _t(caps))
        np.testing.assert_array_equal(out.tokens.numpy(), g.tokens.numpy())


@pytest.mark.parametrize("cur_len", [[0, 5, 9], [13, 14, 16]])
def test_decoder_apply_vec_matches_jax(models, cur_len):
    """One pass of 3 tokens at per-lane cursors: logits and both self caches
    equal JAX's, including lanes whose writes run past the capacity of 16
    (the writes that do not fit vanish)."""
    vparams, _, tv, _ = models
    _, _, v_mem, v_mask = _memories(models, 3, 3, 4000)
    rng = np.random.default_rng(4)
    cap, s = 16, 3
    shape = (VERIFY_CFG.decoder_layers, 3, VERIFY_CFG.decoder_kv_heads, VERIFY_CFG.head_dim, cap)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    toks = rng.integers(0, VERIFY_CFG.vocab_size, (3, s))
    jk, jv = jm.compute_cross_kv(vparams["decoder"], VERIFY_CFG, jnp.asarray(v_mem))
    ref_logits, ref_k, ref_v = _jax_apply_vec(
        vparams["decoder"], VERIFY_CFG, jnp.asarray(toks, jnp.int32),
        jnp.asarray(cur_len, jnp.int32), jnp.asarray(k0), jnp.asarray(v0), jk, jv,
        jnp.asarray(v_mask))
    kc, vc = (_t(x) for x in (k0, v0))
    tk, tvv = (_t(np.asarray(x)) for x in (jk, jv))
    logits = spec._decoder_apply_vec(tv.decoder, TVERIFY, _t(toks), _t(cur_len), kc, vc, tk, tvv,
                                     _t(v_mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(kc.numpy(), np.asarray(ref_k), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vc.numpy(), np.asarray(ref_v), atol=1e-5, rtol=1e-5)
    # Slots no write reaches keep their values exactly.
    untouched = np.ones((3, cap), bool)
    for lane, c in enumerate(cur_len):
        untouched[lane, c:c + s] = False
    np.testing.assert_array_equal(kc.numpy().transpose(1, 4, 0, 2, 3)[untouched],
                                  k0.transpose(1, 4, 0, 2, 3)[untouched])


def test_single_rejects_a_batch(models):
    _, _, tv, td = models
    mem = torch.zeros(2, 5, 64)
    mask = torch.ones(2, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match="one utterance"):
        spec.speculative_decode(tv, TVERIFY, tv, TVERIFY, mem, mask, mem, mask)
