"""The port's batched streaming update against the JAX package's, on the CPU.

The JAX parameters go to the port through the canonical state dict
(``export_streaming_state_dict``, then the port's ``import_streaming``);
the small ``CFG`` of tests/test_serving.py.  Seeded schedules of updates
(per-stream frame counts, resets, final flags, decode masks, drafts fed
back from each side's own previous tokens) go through JAX's
``service_update_meta`` and the port's:

- float32 and int8 KV: tokens and counts equal at every update, the final
  states within the tolerances below;
- the lean-reset sweep of tests/test_serving.py (stale bulk buffers left
  in place against eagerly zeroed ones: the same tokens, and JAX's);
- a memory write past ``mem_bucket`` rows (a 256-row state fed a segment
  of more than 2 s), which XLA clamps to the buffer's last block: the
  port clamps the same way;
- ``_single`` and the lean reset's contract (tests/test_int8_kv.py).

The int8-KV references are computed with a single-threaded XLA CPU client
(``torch_xla_reference``), so that they do not depend on the host.

Tolerances: float32 state fields to atol = rtol = 1e-4 (the streaming
tests' float32 bound: every product sums in another order); int8 scales
to rtol 1e-4 (amax of such values over 127); int8 caches equal except
one int8 step at rounding ties of ``quantize_kv``, on at most 1e-3 of the
entries (its float32 inputs differ in the last bits as above); cursors,
tokens and counts equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_xla_reference
from moonshine_tpu.core.config import StreamingConfig
from moonshine_tpu.models import streaming as jms
from moonshine_tpu.models import streaming_batch as jsb
from moonshine_tpu.weights import export_streaming_state_dict as jax_export
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.models import streaming_batch as tsb

# tests/test_serving.py's CFG.
CFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16,
    vocab_size=96, d_model_frontend=32, c1=48, c2=64, max_seq_len=64,
    encoder_depth=2,
)
TCFG = TorchStreamingConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
F32 = dict(atol=1e-4, rtol=1e-4)
SCALE_TOL = dict(atol=1e-7, rtol=1e-4)
INT8_TIES = 1e-3  # largest share of int8 cache entries one step apart

# name -> (kv_int8, S, F, mem_bucket, draft_cap, decode-bucket ladder,
#          updates, schedule seed, audio seed, mode).  "random": the lean
# sweep's random resets, finals, masks and frame counts; "long": one
# segment per stream, full chunks, final at the last update.
CASES = {
    "float32": (False, 3, 64, 512, 32, (256, 384, 512), 10, 1, 0, "random"),
    "int8": (True, 3, 64, 512, 32, (256, 384, 512), 10, 1, 0, "random"),
    "lean_float32_d16": (False, 2, 64, 512, 16, (512,), 9, 99, 16, "random"),
    "lean_float32_d32": (False, 2, 64, 512, 32, (256, 384, 512), 9, 99, 32, "random"),
    "lean_int8_d16": (True, 2, 64, 512, 16, (256, 384, 512), 9, 99, 33, "random"),
    "past_the_cap": (False, 2, 64, 256, 16, (256,), 9, 0, 5, "long"),
    "past_the_cap_int8": (True, 2, 64, 256, 16, (256,), 9, 0, 5, "long"),
}


def _schedule(S, F, n_updates, seed, mode):
    rng = np.random.RandomState(seed)
    for u in range(n_updates):
        if mode == "random":
            yield (rng.randint(0, F + 1, size=S), rng.rand(S) < (0.5 if u in (0, 4) else 0.2),
                   rng.rand(S) < 0.2, rng.rand(S) < 0.85)
        else:
            yield (np.full(S, F), np.full(S, u == 0), np.full(S, u == n_updates - 1),
                   np.ones(S, bool))


def drive(step, mem_len, state, case, zero_bulk=None):
    """Run ``case``'s schedule through ``step(state, chunk, meta, draft,
    draft_cap, dmb) -> (tokens, counts, state)`` (numpy in and out).
    Returns ([(tokens, counts)] per update, the last state)."""
    kv_int8, S, F, mem_bucket, draft_cap, ladder, n_updates, seed, audio_seed, mode = CASES[case]
    audio = (np.random.RandomState(audio_seed).randn(S, 16000 * 4) * 0.1).astype(np.float32)
    cursors, fed, drafts = [0] * S, [0] * S, [[] for _ in range(S)]
    outs = []
    for n_frames, reset, is_final, decode_mask in _schedule(S, F, n_updates, seed, mode):
        chunk = np.zeros((S, F * CFG.frame_len), np.float32)
        for s in range(S):
            if reset[s]:
                fed[s], drafts[s] = 0, []
            n = n_frames[s] * CFG.frame_len
            seg = audio[s][cursors[s]:cursors[s] + n]
            chunk[s, :len(seg)] = seg
            cursors[s] = (cursors[s] + n) % (audio.shape[1] - F * CFG.frame_len)
            fed[s] += int(n_frames[s])
        budget = np.asarray([min(int(6.5 * f * CFG.frame_len / 16000.0) + 1,
                                 CFG.max_seq_len - 2) for f in fed], np.int32)
        draft = np.full((S, draft_cap), CFG.eos_id, np.int32)
        dlen = np.zeros((S,), np.int32)
        for s in range(S):
            d = drafts[s][:draft_cap]
            draft[s, :len(d)] = d
            dlen[s] = len(d)
        # The decode bucket as serving picks it: the smallest covering this
        # update's longest memory.
        max_mem = int(mem_len(state).max()) + jsb.ENC_STEP
        dmb = next((b for b in ladder if b >= max_mem), ladder[-1])
        if zero_bulk is not None:
            state = zero_bulk(state, reset)
        meta = np.stack([n_frames, reset, is_final, dlen, budget, decode_mask]).astype(np.int32)
        tokens, counts, state = step(state, chunk, meta, draft, draft_cap, dmb)
        for s in range(S):
            if decode_mask[s]:
                drafts[s] = list(tokens[s, :counts[s]])
        outs.append((tokens, counts))
    return outs, state


# -- the JAX side ---------------------------------------------------------------

def _jax_params():
    return jms.init_params(CFG, jax.random.PRNGKey(3))


def jax_drive(params, case):
    kv_int8, S, _, mem_bucket = CASES[case][:4]

    def step(state, chunk, meta, draft, draft_cap, dmb):
        out = jsb.service_update_meta(params, CFG, state, jnp.asarray(chunk), jnp.asarray(meta),
                                      jnp.asarray(draft), mem_bucket=mem_bucket,
                                      draft_cap=draft_cap, decode_mem_bucket=dmb)
        return np.array(out.tokens), np.array(out.counts), out.state

    state = jsb.init_batch_state(CFG, S, mem_cap=mem_bucket, kv_int8=kv_int8)
    return drive(step, lambda st: np.asarray(st.mem_len), state, case)


def _flat(outs, state) -> dict:
    out = {"tokens": np.stack([t for t, _ in outs]), "counts": np.stack([c for _, c in outs])}
    for name, x in zip(jsb.BatchedStreamingState._fields, state):
        if x is not None:
            out["state_" + name] = np.asarray(x)
    return out


def int8_references(inputs: dict) -> dict:
    """JAX's run of every int8-KV case (run by ``torch_xla_reference`` with
    a single-threaded XLA CPU client)."""
    params = _jax_params()
    out = {}
    for case in CASES:
        if CASES[case][0]:
            out.update({f"{case}__{k}": v for k, v in _flat(*jax_drive(params, case)).items()})
    return out


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


@pytest.fixture(scope="module")
def model(jax_params):
    return weights.import_streaming(jax_export(jax_params, CFG), TCFG, device="cpu")


@pytest.fixture(scope="module")
def int8_refs(tmp_path_factory):
    refs = torch_xla_reference.single_threaded(__file__, "int8_references", {},
                                               tmp_path_factory.mktemp("batch_int8"))
    cases = {}
    for key, v in refs.items():
        case, name = key.split("__")
        cases.setdefault(case, {})[name] = v
    return cases


def reference(case, jax_params, int8_refs) -> dict:
    return int8_refs[case] if CASES[case][0] else _flat(*jax_drive(jax_params, case))


# -- the port's side ------------------------------------------------------------

def port_drive(model, case, eager: bool = False):
    kv_int8, S, _, mem_bucket = CASES[case][:4]

    def step(state, chunk, meta, draft, draft_cap, dmb):
        out = tsb.service_update_meta(model, TCFG, state, torch.from_numpy(chunk),
                                      torch.from_numpy(meta), torch.from_numpy(draft),
                                      mem_bucket=mem_bucket, draft_cap=draft_cap,
                                      decode_mem_bucket=dmb)
        return out.tokens.numpy().copy(), out.counts.numpy().copy(), out.state

    def zero_bulk(state, reset):
        """Zero the bulk buffers the lean reset skips, for the streams
        flagged in ``reset`` (the eager reset)."""
        reset = torch.from_numpy(reset)
        for name, x in zip(tsb.BatchedStreamingState._fields, state):
            if x is None or name not in tsb._RESET_SKIP_FIELDS:
                continue
            if name in tsb._KV_FIELDS or name in tsb._KV_SCALE_FIELDS:
                x[:, reset] = 0  # the stream axis is axis 1 (layer-major)
            else:
                x[reset] = 0
        return state

    state = tsb.init_batch_state(TCFG, S, mem_cap=mem_bucket, kv_int8=kv_int8, device="cpu")
    return drive(step, lambda st: st.mem_len.numpy(), state, case,
                 zero_bulk=zero_bulk if eager else None)


def assert_tokens_equal(outs, ref: dict) -> None:
    for u, (tokens, counts) in enumerate(outs):
        np.testing.assert_array_equal(counts, ref["counts"][u], err_msg=f"update {u} counts")
        np.testing.assert_array_equal(tokens, ref["tokens"][u], err_msg=f"update {u} tokens")


def assert_state_close(state: tsb.BatchedStreamingState, ref: dict) -> None:
    for name, x in zip(tsb.BatchedStreamingState._fields, state):
        want = ref.get("state_" + name)
        assert (x is None) == (want is None), name
        if x is None:
            continue
        got = x.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= INT8_TIES, (name, diff.max(),
                                                                        (diff > 0).mean())
        elif name in tsb._KV_SCALE_FIELDS:
            np.testing.assert_allclose(got, want, **SCALE_TOL, err_msg=name)
        elif np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **F32, err_msg=name)


@pytest.mark.parametrize("case", ["float32", "int8"])
def test_service_update_meta_matches_jax(model, jax_params, int8_refs, case):
    outs, state = port_drive(model, case)
    ref = reference(case, jax_params, int8_refs)
    assert_tokens_equal(outs, ref)
    assert_state_close(state, ref)
    assert ref["counts"].sum() > 0  # the schedule decoded tokens


@pytest.mark.parametrize("case", ["lean_float32_d16", "lean_float32_d32", "lean_int8_d16"])
def test_lean_reset_matches_eager_reset(model, jax_params, int8_refs, case):
    """Random reset schedules give the same tokens whether the bulk
    buffers the lean ``_mask_reset`` skips are left stale or eagerly
    zeroed at every reset, and JAX's tokens."""
    lean, _ = port_drive(model, case)
    eager, _ = port_drive(model, case, eager=True)
    for u, ((lt, lc), (et, ec)) in enumerate(zip(lean, eager)):
        np.testing.assert_array_equal(lc, ec, err_msg=f"update {u} counts")
        np.testing.assert_array_equal(lt, et, err_msg=f"update {u} tokens")
    assert_tokens_equal(lean, reference(case, jax_params, int8_refs))


@pytest.mark.parametrize("case", ["past_the_cap", "past_the_cap_int8"])
def test_write_past_the_cap_clamps_as_jax(model, jax_params, int8_refs, case):
    """A segment longer than the state's 256 memory rows: from mem_len 129
    on, each encode's ENC_STEP block is written from row 128 (XLA's clamp),
    over rows already written, while mem_len keeps counting."""
    outs, state = port_drive(model, case)
    ref = reference(case, jax_params, int8_refs)
    assert int(state.mem_len.max()) > 256 + tsb.ENC_STEP
    assert_tokens_equal(outs, ref)
    assert_state_close(state, ref)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_single_matches_jax(kv_int8):
    """``_single`` of a state with distinct per-stream contents: each
    field of stream 1, KV caches back to [L, T, H, hd], int8 dequantized."""
    rng = np.random.default_rng(4)
    jstate = jsb.init_batch_state(CFG, 2, mem_cap=128, kv_int8=kv_int8)
    vals = {}
    for name, x in zip(jsb.BatchedStreamingState._fields, jstate):
        if x is None:
            continue
        x = np.asarray(x)
        if x.dtype == np.int8:
            vals[name] = rng.integers(-127, 128, x.shape).astype(np.int8)
        elif np.issubdtype(x.dtype, np.integer):
            vals[name] = rng.integers(0, 50, x.shape).astype(x.dtype)
        else:
            vals[name] = rng.random(x.shape).astype(x.dtype)
    jstate = jstate._replace(**{k: jnp.asarray(v) for k, v in vals.items()})
    tstate = tsb.init_batch_state(TCFG, 2, mem_cap=128, kv_int8=kv_int8, device="cpu")
    tstate = tstate._replace(**{k: torch.from_numpy(v) for k, v in vals.items()})
    ref, got = jsb._single(jstate, 1), tsb._single(tstate, 1)
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(a, int):
            assert a == int(b), name
        else:
            assert a.dtype == torch.float32 or not kv_int8 or name not in tsb._KV_FIELDS
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, err_msg=name)


def test_batch_state_reset_contract():
    """The lean reset clears the control state (cursors, carries) of the
    flagged streams and retains the bulk KV and scale buffers, whose stale
    contents the cleared cursors make unreachable."""
    st = tsb.init_batch_state(TCFG, 2, mem_cap=128, kv_int8=True, device="cpu")
    st = st._replace(k_cross_scale=st.k_cross_scale + 1.0, k_self_scale=st.k_self_scale + 2.0,
                     mem_len=st.mem_len + 7, feat_count=st.feat_count + 9,
                     conv1_carry=st.conv1_carry + 3.0)
    out = tsb._mask_reset(st, torch.tensor([True, False]))
    assert out.mem_len.tolist() == [0, 7] and out.feat_count.tolist() == [0, 9]
    assert float(out.conv1_carry[0].abs().max()) == 0 and float(out.conv1_carry[1].min()) == 3
    assert bool((out.k_cross_scale == 1.0).all()) and bool((out.k_self_scale == 2.0).all())
    assert out.k_cross_scale is st.k_cross_scale  # retained, not copied


def test_cast_params_keeps_frontend_and_scales(model):
    """bf16 cast: encoder, adapter and decoder in bf16, the frontend
    float32; a cast of a cast model is the model itself."""
    cast = tsb.cast_params(model, torch.bfloat16)
    assert cast.frontend is model.frontend
    assert all(p.dtype == torch.bfloat16 for m in (cast.encoder, cast.adapter, cast.decoder)
               for p in m.parameters())
    assert all(p.dtype == torch.float32 for p in model.decoder.parameters())  # untouched
    assert tsb.cast_params(cast, torch.bfloat16) is cast
