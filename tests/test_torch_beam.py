"""The port's beam search against the JAX package's, on the CPU: the same
JAX-initialised weights (carried across with ``weights.params_from_jax_numpy``)
and the same encoder memory go through both.  The JAX side runs with
``gather_impl="auto"``, which off the TPU is its ``jnp.take`` branch; the
port's ``"auto"`` runs the plain version of its gather kernels here.

Tolerances: tokens and lengths must be identical; scores agree to
atol 1e-4.  In the float cases the scores differ by float32 sums taken in
another order, nothing else.  In the int8-KV cases a last-bit difference
of a product can also move a cached value by a whole int8 step, where it
sits at a rounding tie of ``quantize_kv``; XLA's multi-threaded CPU
products sum in an order that depends on the host's thread count, so those
JAX references are computed in one subprocess with a single-threaded XLA
CPU client (``torch_xla_reference``), which makes them the same on every
host.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import torch_xla_reference
from moonshine_tpu.core.config import MoonshineArchConfig
from moonshine_tpu.decoding.beam import beam_decode as jax_beam
from moonshine_tpu.models import moonshine as jm
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import MoonshineArchConfig as TorchArchConfig
from moonshine_tpu_torch.decoding import beam
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.ops import beam_gather as bg

# The beamtest config of tests/test_beam.py.
CFG = MoonshineArchConfig(
    name="beamtest", vocab_size=128, hidden_size=64, intermediate_size=128,
    encoder_layers=2, decoder_layers=2, encoder_heads=4, decoder_heads=4,
    encoder_kv_heads=4, decoder_kv_heads=4,
)
TCFG = TorchArchConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
SCORE_ATOL = 1e-4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((3, 4000)).astype(np.float32) * 0.1)
    lengths = jnp.asarray([4000, 3000, 2200])
    memory, mask = jax.jit(jm.encode, static_argnames=("cfg",))(params, CFG, audio, lengths)
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG, "cpu")
    return params, model, np.asarray(memory), np.asarray(mask)


def _eos_biased_jax(params):
    """The same parameters with a larger EOS embedding row (the output
    projection is tied), so beams finish at different steps by emitting
    EOS."""
    embed = np.array(params["decoder"]["embed"])
    embed[CFG.eos_token_id] *= 6.0
    return dict(params, decoder=dict(params["decoder"], embed=jnp.asarray(embed)))


def _eos_biased(params, model):
    jp = _eos_biased_jax(params)
    tp = weights.params_from_jax_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    return jp, tp


def _jax_beam(params, memory, mask, token_caps=None, **kw):
    return jax_beam(params, CFG, jnp.asarray(memory), jnp.asarray(mask),
                    token_caps=None if token_caps is None else jnp.asarray(token_caps), **kw)


# The int8-KV cases: name -> (beam_decode keywords, EOS-biased weights).
INT8_CASES = {
    "beam3_caps": (dict(beam_size=3, max_tokens=9, length_penalty=0.6, token_caps=[3, 5, 0]),
                   False),
    "beam4": (dict(beam_size=4, max_tokens=9, length_penalty=0.0, token_caps=None), False),
    "beam4_caps": (dict(beam_size=4, max_tokens=9, length_penalty=0.6, token_caps=[6, 1, 9]),
                   False),
    "finished": (dict(beam_size=4, max_tokens=12, length_penalty=0.6), True),
}


def _int8_case(beam_size, max_tokens, length_penalty, caps, biased) -> str:
    return next(name for name, (kw, b) in INT8_CASES.items()
                if (kw["beam_size"], kw["max_tokens"], kw["length_penalty"],
                    kw.get("token_caps"), b) == (beam_size, max_tokens, length_penalty, caps,
                                                 biased))


def int8_references(inputs: dict) -> dict:
    """Every int8-KV case's JAX beam search (run by ``torch_xla_reference``
    with a single-threaded XLA CPU client)."""
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    out = {}
    for name, (kw, biased) in INT8_CASES.items():
        ref = _jax_beam(_eos_biased_jax(params) if biased else params, inputs["memory"],
                        inputs["mask"], kv_int8=True, **kw)
        for field in ("tokens", "lengths", "scores"):
            out[f"{name}_{field}"] = np.asarray(getattr(ref, field))
    return out


@pytest.fixture(scope="module")
def int8_refs(setup, tmp_path_factory):
    _, _, memory, mask = setup
    refs = torch_xla_reference.single_threaded(
        __file__, "int8_references", {"memory": memory, "mask": mask},
        tmp_path_factory.mktemp("beam_int8"))
    return {name: SimpleNamespace(**{f: refs[f"{name}_{f}"] for f in ("tokens", "lengths",
                                                                      "scores")})
            for name in INT8_CASES}


def _both(params, model, memory, mask, int8_ref=None, **kw):
    caps = kw.pop("token_caps", None)
    ref = int8_ref if kw.get("kv_int8") else _jax_beam(params, memory, mask, token_caps=caps,
                                                       **kw)
    out = beam.beam_decode(model, TCFG, _t(memory), _t(mask),
                           token_caps=None if caps is None else _t(caps), **kw)
    return out, ref


def _assert_same(out, ref):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("beam_size,length_penalty,kv_int8,caps", [
    (1, 0.0, False, None),
    (3, 0.0, False, None),
    (3, 0.6, True, [3, 5, 0]),
    (4, 0.6, False, [4, 9, 2]),
    (4, 0.0, True, None),
    (4, 0.6, True, [6, 1, 9]),
])
def test_beam_matches_jax(setup, int8_refs, beam_size, length_penalty, kv_int8, caps):
    params, model, memory, mask = setup
    ref = int8_refs[_int8_case(beam_size, 9, length_penalty, caps, False)] if kv_int8 else None
    out, ref = _both(params, model, memory, mask, ref, beam_size=beam_size, max_tokens=9,
                     length_penalty=length_penalty, kv_int8=kv_int8, token_caps=caps)
    assert out.tokens.shape == (3, 9) and out.tokens.dtype == torch.int64
    _assert_same(out, ref)
    if caps is not None:
        # As in JAX, the first expansion does not check the cap, so a cap of
        # 1 lets a beam emit 2 tokens (the greedy decode stops at 1).
        assert (out.lengths.numpy() <= np.maximum(np.minimum(caps, 9), 2)).all()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_beam_with_finished_beams_matches_jax(setup, int8_refs, kv_int8):
    """Beams that emit EOS at different steps stay in the active set with
    only EOS at log-prob 0 and every other token at -1e9; rows finish at
    different steps, so finished rows ride along while others decode."""
    params, model, memory, mask = setup
    jp, tp = _eos_biased(params, model)
    ref = int8_refs[_int8_case(4, 12, 0.6, None, True)] if kv_int8 else None
    out, ref = _both(jp, tp, memory, mask, ref, beam_size=4, max_tokens=12, length_penalty=0.6,
                     kv_int8=kv_int8)
    _assert_same(out, ref)
    lengths = out.lengths.numpy()
    assert lengths.min() < 12 and len(set(lengths.tolist())) > 1, lengths


def test_top_k_breaks_ties_as_jax():
    """Exact ties (the -1e9 continuations of finished beams, equal scores,
    -0.0 against 0.0) come back in JAX's order: lower index first."""
    rng = np.random.default_rng(0)
    pool = np.array([-1e9, -1e9 - 10, 0.0, -0.0, -3.5, 1.25, 7.0], np.float32)
    x = rng.choice(pool, size=(64, 29)).astype(np.float32)
    x[32:] += rng.standard_normal((32, 29)).astype(np.float32) * (rng.random((32, 29)) < 0.3)
    for k in (1, 3, 4):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = beam.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


def test_beam1_matches_greedy(setup):
    _, model, memory, mask = setup
    g = greedy_decode(model, TCFG, _t(memory), _t(mask), max_tokens=12)
    b = beam.beam_decode(model, TCFG, _t(memory), _t(mask), beam_size=1, max_tokens=12,
                         length_penalty=0.0)
    np.testing.assert_array_equal(b.tokens.numpy(), g.tokens.numpy())
    np.testing.assert_array_equal(b.lengths.numpy(), g.lengths.numpy())


@pytest.mark.parametrize("kv_int8", [False, True])
def test_gather_impls_agree(setup, kv_int8):
    """"auto" (the gather kernels' wrappers) and "xla" (index_select) give
    identical results: the gather is an exact copy either way.  On CPU
    tensors no kernel launches."""
    _, model, memory, mask = setup
    before = (bg.gather_kv_rows.launches, bg.gather_scale_rows.launches)
    runs = [beam.beam_decode(model, TCFG, _t(memory), _t(mask), beam_size=3, max_tokens=8,
                             kv_int8=kv_int8, gather_impl=impl) for impl in ("auto", "xla")]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert runs[0].steps == runs[1].steps
    assert (bg.gather_kv_rows.launches, bg.gather_scale_rows.launches) == before
    with pytest.raises(ValueError, match="gather_impl"):
        beam.beam_decode(model, TCFG, _t(memory), _t(mask), gather_impl="pallas")


@pytest.mark.parametrize("caps", [None, [2, 3, 1]])
def test_beam_steps_count_decode_steps(setup, monkeypatch, caps):
    """``steps`` is the number of decoder calls after the BOS pass, which is
    the number of cache reorders: the loop stops early once every beam has
    finished (here by its token cap) and otherwise at ``max_tokens - 1``."""
    _, model, memory, mask = setup
    calls = []
    inner = beam.mm.decoder_apply
    monkeypatch.setattr(beam.mm, "decoder_apply",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    out = beam.beam_decode(model, TCFG, _t(memory), _t(mask), beam_size=4, max_tokens=12,
                           token_caps=None if caps is None else _t(caps))
    assert out.steps == len(calls) - 1
    assert (out.steps == 11) if caps is None else (out.steps < 11)


def test_beam_base_width_matches_jax():
    """Moonshine Base at full width, the __graft_entry__ dry run's call:
    B=1, beam 2, 4 tokens."""
    from moonshine_tpu.core.config import BASE
    from moonshine_tpu_torch.core.config import BASE as TBASE

    params = jm.init_params(BASE, jax.random.PRNGKey(0))
    model = weights.params_from_jax_numpy(jax.tree.map(np.asarray, params), TBASE, "cpu")
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((1, 52, BASE.hidden_size)).astype(np.float32)
    mask = np.ones((1, 52), bool)
    ref = jax_beam(params, BASE, jnp.asarray(memory), jnp.asarray(mask), beam_size=2,
                   max_tokens=4)
    out = beam.beam_decode(model, TBASE, _t(memory), _t(mask), beam_size=2, max_tokens=4)
    _assert_same(out, ref)
