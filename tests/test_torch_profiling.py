"""The port's span and counter recorder (``moonshine_tpu_torch.profiling``)
and the spans and counters of the decoding and serving layers, on the CPU.

The clock: a span placed on the profiler's clock contains the operation
it wraps and lies inside a ``time.perf_counter()`` bracket.  The counters:
``greedy.decode``'s ``decoder_calls`` and a service update's are the calls
of the decoder a counting wrapper sees, and the update's
``accepted_tokens`` is the verify's own ``n_accept``.  The tiers: outside a
profiler session and with the switch off, a call records its coarse span
alone; fine spans change no token.  A service update's span opens in
``update_begin`` and closes in ``update_end``, also when
``update_all_parallel`` interleaves the cohorts.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch import profiling
from moonshine_tpu_torch.core.config import MoonshineArchConfig, StreamingConfig
from moonshine_tpu_torch.decoding import greedy
from moonshine_tpu_torch.models import moonshine as mm
from moonshine_tpu_torch.models import streaming as ms
from moonshine_tpu_torch.models import streaming_batch as sb
from moonshine_tpu_torch.serving import ShardedStreamingService, StreamingService

ARCH = MoonshineArchConfig(name="tiny", hidden_size=64, intermediate_size=128, encoder_layers=2,
                           decoder_layers=2, encoder_heads=2, decoder_heads=2,
                           encoder_kv_heads=2, decoder_kv_heads=2, vocab_size=512)
SCFG = StreamingConfig(encoder_dim=64, decoder_dim=64, depth=2, nheads=4, head_dim=16,
                       vocab_size=96, d_model_frontend=32, c1=48, c2=64, max_seq_len=64,
                       encoder_depth=2)
KW = dict(update_frames=16, mem_bucket=256, draft_cap=16, max_segment_seconds=1.0)
FINE = {"greedy.prefill", "greedy.step", "greedy.read", "service.plan", "service.ingest",
        "service.verify", "service.step", "service.read", "service.finish"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.clear()
    profiling.enable_device_run_log(False)
    yield
    profiling.enable_device_run_log(False)


@pytest.fixture(scope="module")
def model():
    return mm.init_params(ARCH, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def smodel():
    return ms.init_params(SCFG, torch.Generator().manual_seed(1), device="cpu")


def _memory(batch: int = 3, frames: int = 20):
    g = torch.Generator().manual_seed(2)
    return torch.randn(batch, frames, ARCH.hidden_size, generator=g), torch.ones(batch, frames,
                                                                                 dtype=torch.bool)


def _decode(model):
    memory, mask = _memory()
    return greedy.greedy_decode(model, ARCH, memory, mask, max_tokens=12,
                                token_caps=torch.tensor([4, 11, 7]))


def _audio(seed: int, seconds: float) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(int(16000 * seconds)) * 0.1).astype(np.float32)


def _serve(smodel, updates: int = 6, streams: int = 4):
    """A service of ``streams`` slots fed 0.16 s a slot before each of
    ``updates`` updates; returns its events, update by update."""
    svc = StreamingService(smodel, SCFG, None, streams, device="cpu", **KW)
    audio = [_audio(10 + i, 2.5) for i in range(streams)]
    for i in range(streams):
        svc.open_slot(i)
    step = KW["update_frames"] * SCFG.frame_len
    out = []
    for u in range(updates):
        for i in range(streams):
            svc.add_audio(i, audio[i][u * step:(u + 1) * step])
        out.append(svc.update())
    return out


def test_span_clock_is_the_profilers_and_the_host_clocks():
    """Placed on the profiler's clock, a span around torch.mm contains the
    op's interval; its own stamps lie inside a time.perf_counter()
    bracket."""
    a = torch.randn(192, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lo = time.perf_counter()
        sp = profiling.begin("clock")
        torch.mm(a, a)
        profiling.end(sp)
        hi = time.perf_counter()
    off = profiling.profiler_offset_ns()
    (op,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert sp.start_ns + off <= op.start_ns() <= op.end_ns() <= sp.end_ns + off
    assert lo <= sp.start_ns / 1e9 <= sp.end_ns / 1e9 <= hi


def test_greedy_decoder_calls_are_the_decoder_applys(model, monkeypatch):
    calls = []
    orig = mm.decoder_apply

    def counting(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(mm, "decoder_apply", counting)
    _decode(model)
    (sp,) = profiling.spans("greedy.decode")
    assert sp.attrs["decoder_calls"] == len(calls) > 1
    assert sp.attrs["batch"] == 3 and 0 < sp.attrs["read_ns"] < sp.wall_ns
    assert not sp.enqueued  # a CPU decode is never left running


def _counting_service(monkeypatch):
    """Wrap the service's decoder calls and updates: per update, the
    decoder calls and the verify's n_accept."""
    seen = []
    orig_step, orig_meta = sb._decode_step_batch, sb.service_update_meta

    def step(*args, **kw):
        seen[-1]["calls"] += 1
        return orig_step(*args, **kw)

    def meta(*args, **kw):
        out = orig_meta(*args, **kw)
        if kw.get("decode", True):
            seen[-1]["accepted"] += int(out.n_accept.sum())
        return out

    monkeypatch.setattr(sb, "_decode_step_batch", step)
    monkeypatch.setattr(sb, "service_update_meta", meta)
    return seen


def test_service_update_counters_are_the_devices(smodel, monkeypatch):
    """Each update's decoder_calls is the count of _decode_step_batch calls
    (the verify and each continuation step) and its accepted_tokens, found
    on the host, is the sum of the verify's n_accept."""
    seen = _counting_service(monkeypatch)
    orig_begin = StreamingService.update_begin

    def begin(self, *args, **kw):
        seen.append({"calls": 0, "accepted": 0})
        return orig_begin(self, *args, **kw)

    monkeypatch.setattr(StreamingService, "update_begin", begin)
    _serve(smodel)
    spans = profiling.spans("service.update")
    assert len(spans) == len(seen) == 6
    for sp, s in zip(spans, seen):
        assert sp.attrs["decoder_calls"] == s["calls"]
        assert sp.attrs["accepted_tokens"] == s["accepted"] <= sp.attrs["draft_tokens"]
        assert sp.attrs["streams"] == 4 and sp.attrs["decode"] == 1
        assert 0 < sp.attrs["read_ns"] < sp.wall_ns
    assert sum(sp.attrs["draft_tokens"] for sp in spans) > 0 and sum(s["accepted"] for s in seen) > 0
    assert sum(s["calls"] for s in seen) > len(seen)


def test_fine_spans_change_no_token(model, smodel):
    """The switch on records the fine spans under each coarse one; tokens
    and events are the same as with it off."""
    off = _decode(model), _serve(smodel, updates=4)
    assert {s.name for s in profiling.spans()} & FINE == set()
    profiling.clear()
    profiling.enable_device_run_log(True)
    on = _decode(model), _serve(smodel, updates=4)
    assert torch.equal(off[0].tokens, on[0].tokens) and torch.equal(off[0].lengths,
                                                                    on[0].lengths)
    assert [[(e.slot, e.text, e.is_final) for e in u] for u in off[1]] == \
        [[(e.slot, e.text, e.is_final) for e in u] for u in on[1]]
    recorded = profiling.spans()
    (dec,) = [s for s in recorded if s.name == "greedy.decode"]
    steps = [s for s in recorded if s.name == "greedy.step"]
    assert len(steps) == dec.attrs["decoder_calls"] - 1
    assert all(s.parent == dec.id and s.trace == dec.trace for s in steps)
    reads = [s for s in recorded if s.name == "greedy.read"]
    assert sum(r.wall_ns for r in reads) == dec.attrs["read_ns"]
    updates = [s for s in recorded if s.name == "service.update"]
    names = {s.name for s in recorded if s.trace in {u.trace for u in updates}}
    assert {"service.plan", "service.ingest", "service.verify", "service.finish",
            "service.read"} <= names


def test_only_coarse_spans_outside_a_profiler_with_the_switch_off(model, smodel):
    _decode(model)
    assert [s.name for s in profiling.spans()] == ["greedy.decode"]
    profiling.clear()
    _serve(smodel, updates=2)
    assert [s.name for s in profiling.spans()] == ["service.update"] * 2


def test_update_span_spans_begin_to_end_under_update_all_parallel(smodel):
    svc = ShardedStreamingService(smodel, SCFG, None, 4, n_cohorts=2, device="cpu", **KW)
    for i in range(4):
        svc.open_slot(i)
        svc.add_audio(i, _audio(20 + i, 0.5))
    profiling.clear()
    svc.update_all_parallel()
    first, second = profiling.spans("service.update")
    # Both opened in their update_begin before either update_end closed.
    assert first.start_ns < second.start_ns < first.end_ns < second.end_ns
    assert first.trace != second.trace


def test_profiler_trace_holds_the_program_spans(model, tmp_path):
    """profiler_trace's trace.json holds the spans of the capture (fine
    ones too: the profiler was recording) on a track of their own, on the
    clock of the profiler's events."""
    with profiling.profiler_trace(str(tmp_path)):
        _decode(model)
    trace = json.loads((tmp_path / "trace.json").read_text())
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    theirs = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") != "program_span"]
    names = {e["name"] for e in ours}
    assert {"greedy.decode", "greedy.prefill", "greedy.step", "greedy.read"} <= names
    (dec,) = [e for e in ours if e["name"] == "greedy.decode"]
    mms = [e for e in theirs if e["name"] == "aten::mm"]
    assert mms and all(dec["ts"] <= e["ts"] and e["ts"] + e["dur"] <= dec["ts"] + dec["dur"]
                       for e in mms)
