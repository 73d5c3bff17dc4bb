"""The port's streaming service against the JAX package's, on the CPU.

The same JAX-initialised weights (carried across with the canonical state
dict) and the same seeded audio go through JAX's ``serving`` and the
port's.  Mirrors tests/test_serving.py (batched service, force split,
close before any update, masked frontend), tests/test_sharded_service.py
(cohorts, round robin, shared weights, ``update_live``, the w8a8 scales
under a bfloat16 cast, snapshot and restore mid-stream, a warm VAD
standby, ``devices=``), tests/test_governor.py and the int8-KV service of
tests/test_int8_kv.py.  The VAD runs an in-memory graph of TinyVadCNN's
contract (``chip_smoke.tinyvad_graph``).  The int8-KV reference is computed
with a single-threaded XLA CPU client (``torch_xla_reference``).

Tolerances: event logs (slot, segment, text, final flag, start and end
times) must be identical to JAX's; the masked frontend holds the JAX
test's bounds (atol 1e-5 for the carries, 1e-4 for the features).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from chip_smoke import tinyvad_graph
import torch_xla_reference
from moonshine_tpu import serving as jserving
from moonshine_tpu.core.config import StreamingConfig
from moonshine_tpu.models import streaming as jms
from moonshine_tpu.models.vad import TinyVad as JaxTinyVad
from moonshine_tpu.weights import export_streaming_state_dict as jax_export
from moonshine_tpu_torch import weights
from moonshine_tpu_torch.core.config import StreamingConfig as TorchStreamingConfig
from moonshine_tpu_torch.models import streaming as tms
from moonshine_tpu_torch.models import streaming_batch as tsb
from moonshine_tpu_torch.models.vad import TinyVad
from moonshine_tpu_torch.quant import quantize_tree_exec
from moonshine_tpu_torch.serving import ServiceGovernor, ShardedStreamingService, StreamingService

# tests/test_serving.py's CFG.
CFG = StreamingConfig(
    encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16,
    vocab_size=96, d_model_frontend=32, c1=48, c2=64, max_seq_len=64,
    encoder_depth=2,
)
TCFG = TorchStreamingConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
S, K = 4, 2
SEG_SECONDS = 1.0
KW = dict(update_frames=16, mem_bucket=256, draft_cap=16, max_segment_seconds=SEG_SECONDS)


def _jax_params(seed: int):
    return jms.init_params(CFG, jax.random.PRNGKey(seed))


def _port(params):
    return weights.import_streaming(jax_export(params, CFG), TCFG, device="cpu")


@pytest.fixture(scope="module")
def params3():
    """tests/test_serving.py's weights (seed 3), JAX and port."""
    p = _jax_params(3)
    return p, _port(p)


@pytest.fixture(scope="module")
def params7():
    """tests/test_sharded_service.py's weights (seed 7), JAX and port."""
    p = _jax_params(7)
    return p, _port(p)


def _audio(seed: int, seconds: float) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(int(16000 * seconds)) * 0.1).astype(np.float32)


def _slot_audio(slot: int) -> np.ndarray:
    return _audio(100 + slot, 2.3)


def _services(params, n_streams, **kw):
    jp, tp = params
    return (jserving.StreamingService(jp, CFG, tokenizer=None, n_streams=n_streams, **kw),
            StreamingService(tp, TCFG, tokenizer=None, n_streams=n_streams, device="cpu", **kw))


def _log(events):
    return [(e.slot, e.segment_id, e.text, e.is_final, round(e.start_time, 6),
             round(e.end_time, 6)) for e in events]


def _run(svc, tick, n_ticks=40):
    """tests/test_sharded_service.py's drive: every slot gets its audio and
    is closed, then a fixed number of ticks; the log sorted per slot."""
    for i in range(S):
        svc.open_slot(i)
        svc.add_audio(i, _slot_audio(i))
        svc.close_slot(i)
    log = []
    for _ in range(n_ticks):
        log.extend(_log(tick()))
    return [t for i in range(S) for t in log if t[0] == i]


# -- tests/test_serving.py ----------------------------------------------------------

def test_service_matches_jax(params3):
    """3 slots with different audio in 0.32 s updates, then closed: the
    same events as JAX's service, every update."""
    seconds = [1.2, 0.8, 1.2]
    audios = [_audio(10 + i, s) for i, s in enumerate(seconds)]
    step = 64 * 80
    logs = []
    for svc in _services(params3, 3, update_frames=64, mem_bucket=512, draft_cap=32):
        for i in range(3):
            svc.open_slot(i)
        log = []
        for u in range(max(len(a) for a in audios) // step + 4):
            for i, a in enumerate(audios):
                part = a[u * step:(u + 1) * step]
                if len(part):
                    svc.add_audio(i, part)
                if (u + 1) * step >= len(a) and svc.slots[i].active:
                    svc.close_slot(i)
            log.append(_log(svc.update()))
        logs.append(log)
    assert logs[1] == logs[0]
    assert {e[0] for u in logs[1] for e in u if e[3]} == {0, 1, 2}


def _finals(svc, n_ticks):
    return [(e.segment_id, round(e.start_time, 6), round(e.end_time, 6))
            for _ in range(n_ticks) for e in svc.update() if e.is_final]


def test_service_force_split_rolls_segments(params3):
    out = []
    for svc in _services(params3, 1, update_frames=64, mem_bucket=512, draft_cap=32,
                         max_segment_seconds=0.6):
        svc.open_slot(0)
        svc.add_audio(0, _audio(42, 1.5))
        finals = _finals(svc, 12)
        svc.close_slot(0)
        out.append(finals + _finals(svc, 4))
    finals = out[1]
    assert finals == out[0]
    # 1.5 s at a 0.6 s cap -> 3 segments (0.6, 0.6, 0.3).
    assert [f[0] for f in finals] == [0, 1, 2]
    np.testing.assert_allclose([finals[0][2], finals[1][1], finals[2][2]], [0.6, 0.6, 1.5],
                               atol=0.01)


def test_close_before_updates_flushes_all_segments(params3):
    """Closing a slot while audio is still queued behind an in-flight
    force-split finalizes every remaining segment."""
    out = []
    for svc in _services(params3, 1, update_frames=64, mem_bucket=512, draft_cap=32,
                         max_segment_seconds=0.6):
        svc.open_slot(0)
        svc.add_audio(0, _audio(43, 1.5))
        svc.close_slot(0)  # no update() has run yet: everything still queued
        out.append(_finals(svc, 16))
        s = svc.slots[0]
        assert s.fed_samples == 0 and len(s.pending) == 0 and len(s.raw_buffer) == 0
    assert out[1] == out[0]
    assert [f[0] for f in out[1]] == [0, 1, 2]


def test_masked_frontend_matches_unmasked(params3):
    """Partial-chunk ingest (n_valid < F) reproduces the single-stream
    frontend over all frames at once."""
    model = params3[1]
    audio = _audio(7, 0.8)
    n_total = len(audio) // 80
    ref = tms.frontend_step(model, TCFG, torch.from_numpy(audio[:n_total * 80]),
                            tms.init_state(TCFG, device="cpu"))
    st = tsb.init_batch_state(TCFG, 1, mem_cap=512, device="cpu")
    F = 80
    for lo, hi in ((0, 53), (53, 106), (106, n_total)):
        chunk = np.zeros((1, F * 80), np.float32)
        chunk[0, :(hi - lo) * 80] = audio[lo * 80:hi * 80]
        no = torch.tensor([False])
        st = tsb.service_update(
            model, TCFG, st, torch.from_numpy(chunk), torch.tensor([hi - lo], dtype=torch.int32),
            no, no, torch.full((1, 16), CFG.eos_id, dtype=torch.int32),
            torch.tensor([0]), torch.tensor([0]), no, mem_bucket=512, draft_cap=16,
            decode=False).state
    np.testing.assert_allclose(st.sample_ctx[0].numpy(), ref.sample_ctx.numpy(), atol=1e-5)
    np.testing.assert_allclose(st.conv1_carry[0].numpy(), ref.conv1_carry.numpy(), atol=1e-5)
    np.testing.assert_allclose(st.feats[0, :n_total].numpy(), ref.feats[:n_total].numpy(),
                               atol=1e-4)
    assert int(st.feat_count[0]) == ref.feat_count


# -- tests/test_sharded_service.py -----------------------------------------------------

def _sharded(params, **kw):
    return ShardedStreamingService(params, TCFG, tokenizer=None, n_streams=S, n_cohorts=K,
                                   device="cpu", **{**KW, **kw})


def test_sharded_matches_unsharded_and_jax(params7):
    jax_plain, plain = _services(params7, S, **KW)
    ref = _run(jax_plain, jax_plain.update)
    assert _run(plain, plain.update) == ref
    sharded = _sharded(params7[1])
    assert _run(sharded, sharded.update_all) == ref
    # 2.3 s audio / 1 s force-split cap: 3 final segments per slot.
    assert sum(t[3] for t in ref) == 3 * S


def test_round_robin_update_covers_all_cohorts(params7):
    sharded = _sharded(params7[1])
    for i in range(S):
        sharded.open_slot(i)
        sharded.add_audio(i, _slot_audio(i))
    seen = {e.slot for _ in range(K) for e in sharded.update()}
    assert seen == set(range(S))


def test_cohorts_share_cast_weight_buffers(params7):
    sharded = _sharded(params7[1], compute_dtype=torch.bfloat16)
    a, b = (list(c.params.parameters()) for c in sharded.cohorts)
    assert all(x is y for x, y in zip(a, b))
    assert sharded.cohorts[0].params.decoder.embed.dtype == torch.bfloat16


def test_bad_shard_args_raise(params7):
    with pytest.raises(ValueError, match="divisible"):
        ShardedStreamingService(params7[1], TCFG, None, n_streams=5, n_cohorts=2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        _sharded(params7[1]).open_slot(S)


def test_update_live_skips_empty_cohorts(params7, monkeypatch):
    svc = _sharded(params7[1])
    calls = []
    for c, cohort in enumerate(svc.cohorts):
        orig = cohort.update
        monkeypatch.setattr(cohort, "update",
                            lambda c=c, orig=orig, **kw: (calls.append(c), orig(**kw))[1])
    svc.open_slot(2)  # live slots only in cohort 1 (slots 2, 3)
    svc.add_audio(2, _slot_audio(2))
    for _ in range(4):
        svc.update_live([2])
    assert calls and set(calls) == {1}
    calls.clear()
    assert svc.update_live([]) == []
    assert calls == []


def test_w8a8_scales_stay_f32_under_bf16_cast(params7):
    """cast_params keeps the exec-quantization scales float32 and w_q int8."""
    cast = tsb.cast_params(quantize_tree_exec(params7[1]), torch.bfloat16)
    named = dict(cast.named_parameters())
    scales = [v for k, v in named.items() if k.endswith("w_scale")]
    assert scales and all(v.dtype == torch.float32 for v in scales)
    assert all(v.dtype == torch.int8 for k, v in named.items() if k.endswith("w_q"))
    assert any(v.dtype == torch.bfloat16 for v in named.values())


def _phase1(svc):
    for i in range(S):
        svc.open_slot(i)
        svc.add_audio(i, _slot_audio(i)[:16000])  # the first 1.0 s
    return [t for _ in range(10) for t in _log(svc.update())]  # 12,800 of 16,000 fed


def _phase2(svc):
    for i in range(S):
        svc.add_audio(i, _slot_audio(i)[16000:24000])
        svc.close_slot(i)
    return [t for _ in range(30) for t in _log(svc.update())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snapshot_restore_mid_stream_failover(params7, dtype):
    """A service snapshotted mid-segment and restored into fresh services
    (twice from one snapshot) continues with the transcripts of an
    uninterrupted run; a bfloat16 state keeps its bits through the
    snapshot."""
    kw = dict(KW, compute_dtype=dtype)
    ref_svc = StreamingService(params7[1], TCFG, None, S, device="cpu", **kw)
    ref = _phase1(ref_svc) + _phase2(ref_svc)
    a = StreamingService(params7[1], TCFG, None, S, device="cpu", **kw)
    got1 = _phase1(a)
    snap = a.snapshot()
    assert snap["device_state"].memory.dtype == dtype
    assert torch.equal(snap["device_state"].memory, a.state.memory)
    _phase2(a)  # the source keeps serving: the snapshot must not change
    for _ in range(2):
        b = StreamingService(params7[1], TCFG, None, S, device="cpu", **kw)
        b.restore(snap)
        assert got1 + _phase2(b) == ref
    assert any(t[3] for t in ref)
    if dtype == torch.float32:
        jsvc = jserving.StreamingService(params7[0], CFG, None, S, **KW)
        assert _phase1(jsvc) + _phase2(jsvc) == ref


def test_sharded_snapshot_restore(params7):
    a = _sharded(params7[1])
    for i in range(S):
        a.open_slot(i)
        a.add_audio(i, _slot_audio(i)[:8000])
    for _ in range(4):
        a.update_all()
    snap = a.snapshot()
    b = _sharded(params7[1])
    b.restore(snap)
    ev_a = [(e.slot, e.text) for _ in range(4) for e in a.update_all()]
    ev_b = [(e.slot, e.text) for _ in range(4) for e in b.update_all()]
    assert ev_a == ev_b


def test_sharded_restore_preserves_round_robin_cursor(params7):
    a = _sharded(params7[1])
    a.update()  # the round-robin cursor moves to cohort 1
    b = _sharded(params7[1])
    b.restore(a.snapshot())
    assert b._next == a._next == 1


def test_restore_into_warm_vad_standby_discards_its_segments(params7):
    """A standby that served other traffic does not leak its old VAD
    segments into restored streams."""
    vad = TinyVad(tinyvad_graph(0), device="cpu")
    kw = dict(KW, vad=vad, vad_threshold=0.1)
    standby = StreamingService(params7[1], TCFG, None, S, device="cpu", **kw)
    rng = np.random.RandomState(0)
    for i in range(S):
        standby.open_slot(i)
        standby.add_audio(i, (rng.randn(16000) * 0.5).astype(np.float32))
    for _ in range(3):
        standby.update()
    assert any(standby._segmenters[i].segments for i in range(S))  # voiced traffic
    source = StreamingService(params7[1], TCFG, None, S, device="cpu", **kw)
    for i in range(S):
        source.open_slot(i)
    standby.restore(source.snapshot())
    for _ in range(4):
        assert standby.update() == []
    for s in standby.slots:
        assert s.fed_samples == 0 and len(s.pending) == 0


def test_vad_service_matches_jax(params7):
    """The service with TinyVad over a voiced stream and a silent one:
    the segmenters cut the same segments and the events equal JAX's."""
    graph = tinyvad_graph(0)
    jp, tp = params7
    kw = dict(KW, update_frames=64, vad_threshold=0.5)
    rng = np.random.RandomState(1)
    voiced = np.concatenate([(rng.randn(16000) * 0.3), np.zeros(32000)]).astype(np.float32)
    logs = []
    for svc in (jserving.StreamingService(jp, CFG, None, 2, vad=JaxTinyVad(graph), **kw),
                StreamingService(tp, TCFG, None, 2, vad=TinyVad(graph, device="cpu"),
                                 device="cpu", **kw)):
        for i in range(2):
            svc.open_slot(i)
        log = []
        for u in range(12):
            svc.add_audio(0, voiced[u * 4000:(u + 1) * 4000])
            svc.add_audio(1, np.zeros(4000, np.float32))
            log.append(_log(svc.update()))
        logs.append(log)
    assert logs[1] == logs[0]
    finals = [e for u in logs[1] for e in u if e[3]]
    assert finals and {e[0] for e in finals} == {0}  # the silent stream never speaks


def test_devices_list_matches_unplaced(params7):
    """Cohorts placed with ``devices=`` (here two CPU entries, so cohorts
    share one weight copy per device) give the plain service's
    transcripts through update_all_parallel, and a snapshot restores
    across the placed services."""
    plain = StreamingService(params7[1], TCFG, None, S, device="cpu", **KW)
    ref = _run(plain, plain.update)
    placed = ShardedStreamingService(params7[1], TCFG, None, n_streams=S, n_cohorts=4,
                                     devices=["cpu", "cpu"], **KW)
    assert _run(placed, placed.update_all_parallel) == ref
    assert all(c.params is placed.cohorts[0].params for c in placed.cohorts)
    assert all(c.state.memory.device.type == "cpu" for c in placed.cohorts)

    a = ShardedStreamingService(params7[1], TCFG, None, n_streams=S, n_cohorts=K,
                                devices=["cpu", "cpu"], **KW)
    for i in range(S):
        a.open_slot(i)
        a.add_audio(i, _slot_audio(i)[:8000])
    for _ in range(4):
        a.update_all_parallel()
    b = ShardedStreamingService(params7[1], TCFG, None, n_streams=S, n_cohorts=K,
                                devices=["cpu", "cpu"], **KW)
    b.restore(a.snapshot())
    ev_a = [(e.slot, e.text) for _ in range(4) for e in a.update_all_parallel()]
    ev_b = [(e.slot, e.text) for _ in range(4) for e in b.update_all_parallel()]
    assert ev_a == ev_b


# -- tests/test_governor.py ----------------------------------------------------------------

def test_backoff_rises_under_overload_and_recovers():
    g = ServiceGovernor(update_period_s=0.64, n_cohorts=1, margin=0.85)
    j = jserving.ServiceGovernor(update_period_s=0.64, n_cohorts=1, margin=0.85)
    assert g.budget_ms == 640.0
    for _ in range(5):
        assert g.decode_this_tick() is True
        g.record(100.0)
    assert g.backoff == 1 and not g.overloaded() and g.admit()
    for _ in range(20):
        decode = g.decode_this_tick()
        g.record(2000.0 if decode else 80.0)
    assert g.backoff > 1
    assert g.projected_tick_ms() <= 0.85 * g.budget_ms + 1e-6
    assert g.overloaded() and g.admit()
    seen = [g.backoff]
    for _ in range(60):
        g.decode_this_tick()
        g.record(100.0)
        seen.append(g.backoff)
    assert g.backoff == 1
    assert all(a - b <= 1 for a, b in zip(seen, seen[1:]))
    # JAX's governor, fed the same walls, takes the same decisions.
    trace = [100.0] * 5 + [2000.0, 80.0] * 10 + [100.0] * 20
    ours, theirs = ServiceGovernor(0.64), j
    for wall in trace:
        assert ours.decode_this_tick() == theirs.decode_this_tick()
        ours.record(wall)
        theirs.record(wall)
        assert ours.stats() == theirs.stats()


def test_admission_refused_when_max_backoff_insufficient():
    g = ServiceGovernor(update_period_s=0.64, n_cohorts=1, max_backoff=10)
    for _ in range(10):
        decode = g.decode_this_tick()
        g.record(5000.0 if decode else 900.0)
    assert g.backoff == 10
    assert not g.admit()


def test_decode_cadence_matches_backoff():
    g = ServiceGovernor(update_period_s=0.64)
    g.backoff = 3
    assert [g.decode_this_tick() for _ in range(9)] == [True, False, False] * 3


def test_ingest_only_ticks_defer_decode_but_preserve_transcripts(params7):
    """Decoding every other update ends with the finals of decoding every
    update, and with JAX's."""
    kw = dict(update_frames=16, mem_bucket=256, draft_cap=16, max_segment_seconds=1.0)
    audio = (np.random.RandomState(3).randn(int(16000 * 1.7)) * 0.1).astype(np.float32)

    def run(svc, decode_every):
        for i in range(2):
            svc.open_slot(i)
            svc.add_audio(i, audio)
            svc.close_slot(i)
        return [(e.slot, e.segment_id, e.text) for t in range(60)
                for e in svc.update(decode_tick=(t % decode_every == 0)) if e.is_final]

    every = run(StreamingService(params7[1], TCFG, None, 2, device="cpu", **kw), 1)
    other = run(StreamingService(params7[1], TCFG, None, 2, device="cpu", **kw), 2)
    assert every == other and len(other) == 4  # 1.7 s / 1.0 s cap: 2 finals per slot
    assert run(jserving.StreamingService(params7[0], CFG, None, 2, **kw), 2) == other


# -- tests/test_int8_kv.py: the int8-KV service -------------------------------------------

def _int8_service_run(svc):
    audio = (np.random.RandomState(11).randn(16000) * 0.1).astype(np.float32)
    for i in range(2):
        svc.open_slot(i)
    step = 64 * 80
    finals = {}
    for u in range(8):
        for i in range(2):
            part = audio[u * step:(u + 1) * step]
            if len(part):
                svc.add_audio(i, part)
            if (u + 1) * step >= len(audio) and svc.slots[i].active:
                svc.close_slot(i)
        for ev in svc.update():
            if ev.is_final:
                finals[ev.slot] = ev.text
    return finals


INT8_KW = dict(update_frames=64, mem_bucket=512, draft_cap=32, kv_int8=True)


def int8_references(inputs: dict) -> dict:
    """JAX's int8-KV service run (by ``torch_xla_reference``, with a
    single-threaded XLA CPU client)."""
    svc = jserving.StreamingService(_jax_params(3), CFG, None, 2, **INT8_KW)
    finals = _int8_service_run(svc)
    return {"slots": np.asarray(sorted(finals)),
            "texts": np.asarray([finals[k] for k in sorted(finals)])}


def test_streaming_service_int8_matches_jax(params3, tmp_path):
    """The int8-KV service: JAX's finals, scales written for the encoded
    memory, int8 caches, and ``_single`` dequantizing to float32."""
    svc = StreamingService(params3[1], TCFG, None, 2, device="cpu", **INT8_KW)
    finals = _int8_service_run(svc)
    ref = torch_xla_reference.single_threaded(__file__, "int8_references", {}, tmp_path)
    assert finals == dict(zip(ref["slots"].tolist(), ref["texts"].tolist()))
    st = svc.state
    assert st.k_self.dtype == st.k_cross.dtype == torch.int8
    ml = int(st.mem_len[0])
    assert ml > 0 and bool((st.k_cross_scale[:, 0, :, :ml] > 0).all())
    assert _int8_service_run(StreamingService(params3[1], TCFG, None, 2, device="cpu",
                                              **INT8_KW)) == finals
    assert tsb._single(st, 0).k_cross.dtype == torch.float32


def test_streaming_bench_runs_on_a_synthetic_wav(tmp_path, monkeypatch):
    """``eval/streaming_bench.run_bench`` over a synthetic wav: the bench's
    loop, its keys and counts (a small config stands in for the catalog's)."""
    from moonshine_tpu_torch.audio.wav import save_wav
    from moonshine_tpu_torch.core import config as tconfig
    from moonshine_tpu_torch.eval import streaming_bench

    path = str(tmp_path / "noise.wav")
    save_wav(path, _audio(5, 3.0), 16000)
    monkeypatch.setitem(tconfig.STREAMING_ARCHS, "tiny_streaming", TCFG)
    out = streaming_bench.run_bench(n_streams=4, n_cohorts=2, n_updates=3, audio_path=path,
                                    mem_bucket=512, draft_cap=32, device="cpu")
    assert out["n_streams"] == 4 and out["n_updates"] == 3 and out["n_finals"] == 0
    assert out["update_ms_p50"] > 0 and out["aggregate_realtime_x"] > 0
