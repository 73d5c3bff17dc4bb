"""Live captioning: ``serving.ShardedStreamingService`` over always-voice
streams, cohorts ticked in turn in a closed loop.

Set-up builds the service, runs its ``warmup()``, then the stagger of the
JAX bench's service harness: slot i receives i/S of a segment at once,
drained by ingest-only updates, so that segments end at different updates.
Each window step feeds ``update_frames`` frames of audio to every slot of
one cohort and runs ``update(cohort=c)``; the audio is Gaussian noise from
the seed, a base clip tiled, slot i reading from i/S of it.

Every feed and update is logged, so that the check can replay the schedule
with the plain reference (``reference.streaming.ServiceSchedule``).

The trace follows the window in every run, on a second service built
as the first was once the first is freed: the stagger drained, then the
first decoding update of each cohort, traced.  No stream has a draft
yet, so each decodes its open segment to its budget: the same sizes for
every seed and every run, whatever the window got through.  Its device
time per audio second is the cell's end-to-end metric
(``metrics/serve_device_ms_per_audio_s.py``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import flops, gap, traffic
from ..trace import traced
from ..weights import leaf_shapes
from .common import benchmark_weights, dtype_of, meta_model, now, program_model, sync

SERVED_BF16 = ("encoder.", "adapter.", "decoder.")  # the frontend stays float32


def _weights(ctx) -> dict:
    bf16 = SERVED_BF16 if ctx.cell.precision["weights"] == "bfloat16" else ()
    return benchmark_weights(ctx.state["shapes"], ctx.seed, ctx.device, bf16)


def setup(ctx) -> None:
    from moonshine_tpu_torch.core.config import StreamingConfig
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.serving import ShardedStreamingService

    arch, mix = ctx.cell.config["arch"], ctx.cell.traffic
    ctx.state["shapes"] = leaf_shapes(meta_model(ms.init_params, StreamingConfig(**arch)))
    ctx.state["program"] = (StreamingConfig, ms, ShardedStreamingService)
    svc = _service(ctx)
    ctx.mark("weights and service")
    svc.warmup()
    ctx.mark("service warmup()")
    n = mix["streams"]
    base = (traffic.rng(ctx.seed, 5).standard_normal(int(mix["base_audio_s"] * 16000))
            * mix["noise_std"]).astype(np.float32)
    tiled = np.concatenate([base] * 4)
    starts = [int(i * len(base) / n) for i in range(n)]
    ctx.state.update(svc=svc, tiled=tiled, starts=starts, cursors=[0] * n, log=[], updates=0,
                     cohort=0, step=mix["update_frames"] * arch["frame_len"], served=[], per_update=[])
    _stagger(ctx, ctx.state)
    sync(ctx.device)
    ctx.mark("stagger drained")


def _service(ctx):
    """The program's service over the benchmark's weights for the seed."""
    Config, ms, Service = ctx.state["program"]
    arch, mix = ctx.cell.config["arch"], ctx.cell.traffic
    cfg = Config(**arch)
    model = program_model(meta_model(ms.init_params, cfg), _weights(ctx), ctx.device)
    return Service(
        model, cfg, None, n_streams=mix["streams"], n_cohorts=mix["cohorts"],
        compute_dtype=dtype_of(ctx.cell.precision), device=ctx.device,
        update_frames=mix["update_frames"], mem_bucket=mix["mem_bucket"],
        draft_cap=mix["draft_cap"], max_tokens_per_second=mix["tokens_per_second"],
        max_segment_seconds=mix["max_segment_seconds"], kv_int8=ctx.cell.precision["kv_int8"])


def _stagger(ctx, st: dict) -> None:
    """Slot i receives i/S of a segment at once, drained by ingest-only
    updates of every cohort."""
    mix = ctx.cell.traffic
    n, step = mix["streams"], ctx.state["step"]
    period = int(mix["max_segment_seconds"] * 16000)
    for i in range(n):
        _feed(ctx, i, (i * period // n) // step * step, st)
    for _ in range(int(mix["max_segment_seconds"] / (step / 16000)) + 4):
        for c in range(mix["cohorts"]):
            _update(ctx, c, decode_tick=False, st=st)


def _feed(ctx, slot: int, n: int, st: dict | None = None) -> None:
    """Feed ``n`` samples to ``slot`` of the service ``st`` holds (the
    window's where None), logging it."""
    st = ctx.state if st is None else st
    if n:
        at = st["starts"][slot] + st["cursors"][slot]
        st["svc"].add_audio(slot, st["tiled"][at:at + n])
        st["cursors"][slot] += n
        st["log"].append(("add", slot, n))


def _cohort(ctx, c: int) -> list[int]:
    per = ctx.cell.traffic["streams"] // ctx.cell.traffic["cohorts"]
    return list(range(c * per, (c + 1) * per))


def _update(ctx, c: int, decode_tick: bool = True, st: dict | None = None):
    st = ctx.state if st is None else st
    events = st["svc"].update(cohort=c, decode_tick=decode_tick)
    st["log"].append(("update", c, decode_tick))
    st["updates"] += 1
    return events


def _step(ctx, c: int):
    """Feed one cohort and update it; returns (events, wall start, end)."""
    for i in _cohort(ctx, c):
        _feed(ctx, i, ctx.state["step"])
    t0 = now()
    events = _update(ctx, c)
    return events, t0, now()


def _note(ctx, c: int, events, in_window: bool) -> None:
    """Keep the hypotheses the window served (partial and final, with the
    update that served them) and each slot's decoded tokens and segment
    length (for the window's model FLOPs)."""
    st = ctx.state
    u = st["updates"] - 1
    for e in events:
        if in_window:
            st["served"].append((u, e.slot, e.segment_id, e.is_final, round(e.start_time, 6),
                                 round(e.end_time, 6), json.loads(e.text)))
    if in_window:
        st["per_update"].append(_slot_work(st["svc"], c, events))


def _slot_work(svc, c: int, events) -> dict:
    """slot -> (tokens decoded, seconds of its segment) of cohort ``c``'s
    update that returned ``events``."""
    served = {}
    for e in events:
        served[e.slot] = (len(json.loads(e.text)), e.end_time - e.start_time)
    base = c * len(svc.cohorts[c].slots)
    for j, s in enumerate(svc.cohorts[c].slots):
        if base + j not in served and s.fed_samples:
            served[base + j] = (len(s.tokens), s.fed_samples / 16000)
    return served


def _work_flops(arch: dict, frames: int, per_update) -> int:
    """Model FLOPs of ``frames`` ingested and of the updates' decoding
    (``_slot_work`` of each)."""
    return flops.streaming_ingest_flops(arch, frames) + sum(
        flops.streaming_decode_flops(arch, int(secs * 16000) // arch["frame_len"], n_tok)
        for served in per_update for n_tok, secs in served.values())


def window(ctx, seconds: float) -> dict:
    st, rec, mix = ctx.state, ctx.record, ctx.cell.traffic
    k, per = mix["cohorts"], mix["streams"] // mix["cohorts"]
    st["window_start"] = st["updates"]
    audio_s, c, updates = 0.0, st["cohort"], 0
    t_start = now()
    while True:
        events, ta, tb = _step(ctx, c)
        rec.span("update", ta, tb, cohort=c)
        _note(ctx, c, events, True)
        audio_s += per * st["step"] / 16000
        c, updates = (c + 1) % k, updates + 1
        if tb - t_start >= seconds:
            break
    rec.window_s = tb - t_start
    st["window_end"] = st["window_start"] + updates
    arch = ctx.cell.config["arch"]
    model_flops = _work_flops(arch, per * mix["update_frames"] * updates, st["per_update"])
    rec.counters.update(attempted=per * updates, failed=0, audio_s=audio_s, updates=updates,
                        model_flops=model_flops, peak_flops=flops.peak_flops(ctx.cell.precision),
                        hypotheses=len(st["served"]),
                        finals=sum(1 for h in st["served"] if h[3]))
    return {}


def trace(ctx, host: bool = True) -> None:
    """Free the window's service (keeping what the check compares), build
    a second, drain its stagger, and trace its first decoding update of
    each cohort: their device time, work and audio for the metric
    readers."""
    st, mix, arch = ctx.state, ctx.cell.traffic, ctx.cell.config["arch"]
    _keep_open_segments(ctx)
    st.pop("svc")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    fresh = {"svc": _service(ctx), "starts": st["starts"], "tiled": st["tiled"],
             "cursors": [0] * mix["streams"], "log": [], "updates": 0}
    for i in range(mix["streams"]):  # as warmup() leaves them, without its updates
        fresh["svc"].open_slot(i)
    _stagger(ctx, fresh)
    per_update = []
    for u in range(mix["trace_updates"]):
        c = u % mix["cohorts"]
        for i in _cohort(ctx, c):
            _feed(ctx, i, st["step"], fresh)
        events, session = traced("update", lambda c=c: _update(ctx, c, st=fresh), host)
        ctx.record.sessions.append(session)
        per_update.append(_slot_work(fresh["svc"], c, events))
    per = mix["streams"] // mix["cohorts"]
    ctx.record.counters.update(
        traced_audio_s=len(per_update) * per * st["step"] / 16000,
        traced_model_flops=_work_flops(arch, len(per_update) * per * mix["update_frames"],
                                       per_update))
    del fresh
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _keep_open_segments(ctx) -> None:
    """Copy the state of a sample of the streams' open segments (drawn from
    the seed, the longest among them): each one's memory rows and its
    cross K/V, dequantized where the caches are int8."""
    st, mix = ctx.state, ctx.cell.traffic
    sched, _ = schedule(ctx)
    segs = [s.segment for s in sched.slots if s.segment is not None and s.segment.samples]
    if not segs:
        st["open"] = []
        return
    longest = max(range(len(segs)), key=lambda j: segs[j].samples)
    per = mix["streams"] // mix["cohorts"]
    kept = []
    for j in gap.sample(traffic.rng(ctx.seed, 7), len(segs), mix["check_memories"], longest):
        seg = segs[j]
        state = st["svc"].cohorts[seg.slot // per].state
        i = seg.slot % per
        n = int(state.mem_len[i])
        kv = []
        for name in ("k_cross", "v_cross"):
            x = getattr(state, name)[:, i, :, :, :n].float()  # [L, H, hd, T]
            scale = getattr(state, name + "_scale")
            if scale is not None:
                x = x * scale[:, i, None, :, :n].permute(0, 2, 1, 3)
            kv.append(x.permute(0, 3, 1, 2).clone())  # [L, T, H, hd]
        kept.append((seg, state.memory[i, :n].clone(), *kv))
    st["open"] = kept


def release(ctx) -> None:
    if "svc" in ctx.state:  # the trace has not freed it
        _keep_open_segments(ctx)
    ctx.state.pop("svc", None)
    ctx.state.pop("program", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def schedule(ctx):
    """The reference's replay of every feed and update the run made;
    returns (the schedule, the segments the window's updates finalized)."""
    from reference.streaming import ServiceSchedule

    mix, st = ctx.cell.traffic, ctx.state
    sched = ServiceSchedule(ctx.cell.config["arch"], mix["streams"], mix["update_frames"],
                            mix["max_segment_seconds"], mix["tokens_per_second"])
    finals, u = [], 0
    for action in st["log"]:
        if action[0] == "add":
            sched.add_audio(action[1], action[2])
        else:
            done = sched.update(_cohort(ctx, action[1]), decode_tick=action[2])
            if st["window_start"] <= u < st["window_end"]:
                finals += done
            u += 1
    return sched, finals


def checked_hypotheses(ctx):
    """(finals that disagree with the replayed schedule, sample of (segment,
    memory rows, served tokens, stopped)): the sample drawn from the seed
    out of every hypothesis the window served, partial and final, the
    longest among them."""
    sched, expected = schedule(ctx)
    segments = {(s.slot, s.segment_id): s for s in sched.segments}
    want = {(s.slot, s.segment_id): s for s in expected}
    got = {(h[1], h[2]): h for h in ctx.state["served"] if h[3]}
    wrong = len(set(want) ^ set(got)) + sum(
        1 for key in set(want) & set(got)
        if (round(want[key].start_sample / 16000, 6),
            round((want[key].start_sample + want[key].samples) / 16000, 6)) != got[key][4:6])
    served = []
    for u, slot, seg_id, _, _, _, tokens in ctx.state["served"]:
        seg = segments.get((slot, seg_id))
        if seg is None or u not in seg.decoded_at:
            wrong += 1  # served at an update that decoded no such segment
            continue
        rows, budget = seg.decoded_at[u]
        served.append((seg, rows, tokens, len(tokens) < budget))
    if not served:
        return wrong, []
    longest = max(range(len(served)), key=lambda j: len(served[j][2]))
    picked = gap.sample(traffic.rng(ctx.seed, 6), len(served),
                        ctx.cell.traffic["check_hypotheses"], longest)
    return wrong, [served[j] for j in picked]


def segment_audio(ctx, seg) -> torch.Tensor:
    st = ctx.state
    at = st["starts"][seg.slot] + seg.start_sample
    return torch.from_numpy(st["tiled"][at:at + seg.samples]).to(ctx.device)


def _reference_memory(ctx, seg, w, p):
    """The reference's memory of a segment, computed once a precision (a
    segment's memory only grows: its rows serve every earlier update)."""
    from reference import streaming as ref

    cache = ctx.state.setdefault("ref_memories", {})
    key = (seg.slot, seg.segment_id, p.mode)
    if key not in cache:
        cache[key] = ref.segment_memory(w, ctx.cell.config["arch"], segment_audio(ctx, seg),
                                        seg.passes, p)
    return cache[key]


def reference_logits(ctx, sample, mode: str = "float32"):
    from reference import streaming as ref
    from reference.numerics import Products

    arch = ctx.cell.config["arch"]
    w = _weights(ctx)
    p = Products(mode)
    out = []
    for seg, rows, tokens, stopped in sample:
        memory = _reference_memory(ctx, seg, w, p)[:rows]
        inputs, targets = gap.forced_inputs(arch["bos_id"], tokens, arch["eos_id"], stopped)
        logits = ref.forced_logits(w, arch, memory, torch.tensor(inputs, device=ctx.device), p,
                                   ctx.cell.precision["kv_int8"])
        out.append((logits, torch.tensor(targets, device=ctx.device)))
    return out


def reference_states(ctx, mode: str = "float32") -> list:
    """(program memory, reference memory, program K/V, reference K/V) of
    each kept open segment; K/V [L, T, H, hd] of every layer."""
    from reference.numerics import Products, int8_columns

    arch = ctx.cell.config["arch"]
    w, p = _weights(ctx), Products(mode)
    quant = int8_columns if ctx.cell.precision["kv_int8"] else (lambda x: x)
    out = []
    for seg, memory, k, v in ctx.state["open"]:
        mem = _reference_memory(ctx, seg, w, p)
        t, heads, hd = mem.shape[0], arch["nheads"], arch["head_dim"]
        kv = [torch.stack([quant(p.linear(mem, w[f"decoder.layers.{i}.cross_attn.{x}.weight"])
                                 .view(t, heads, hd)) for i in range(arch["depth"])])
              for x in ("k", "v")]
        out.append((memory, mem, torch.cat([k, v]), torch.cat(kv)))
    return out


def _state_errors(pairs) -> tuple[float, float]:
    mem = kv = 0.0
    for ours_m, ref_m, ours_kv, ref_kv in pairs:
        if ours_m.shape != ref_m.shape:
            return 1e9, 1e9  # the memory holds another number of frames
        mem = max(mem, gap.rel_rms(ours_m, ref_m))
        kv = max(kv, gap.rel_rms(ours_kv, ref_kv))
    return mem, kv


def check(ctx) -> dict:
    wrong, sample = checked_hypotheses(ctx)
    pairs = reference_logits(ctx, sample)
    mem, kv = _state_errors(reference_states(ctx))
    tie = ctx.cell.precision["logit_tie"]
    ctx.record.counters.update(
        checked_tokens=sum(len(t) for _, _, t, _ in sample),
        widest_gap=max((gap.served_gap(lg, tg) for lg, tg in pairs), default=None))
    limits = ctx.cell.limits
    return {"hypotheses_wrong": {"value": wrong, "limit": 0},
            "no_final_served": {"value": int(not any(h[3] for h in ctx.state["served"])),
                                "limit": 0},
            "no_open_segment": {"value": int(not ctx.state["open"]), "limit": 0},
            "tokens_not_best": {"value": sum(gap.not_best(lg, tg, tie) for lg, tg in pairs)
                                if pairs else None, "limit": 0},
            "memory_rel_err": {"value": mem, "limit": limits.get("memory_rel_err")},
            "cross_kv_rel_err": {"value": kv, "limit": limits.get("cross_kv_rel_err")}}


def control(ctx, mode: str) -> dict:
    """The control's numbers: the tokens that the reference computed in
    ``mode`` puts first over the checked hypotheses (their widest gap, and
    those not the best), and its open segments' memory and cross K/V
    against the float32 reference's."""
    _, sample = checked_hypotheses(ctx)
    pairs = list(zip(reference_logits(ctx, sample), reference_logits(ctx, sample, mode)))
    low = [(lo_m, ref_m, lo_kv, ref_kv) for (_, ref_m, _, ref_kv), (_, lo_m, _, lo_kv)
           in zip(reference_states(ctx), reference_states(ctx, mode))]
    mem, kv = _state_errors(low)
    firsts = [(ref, lo.argmax(dim=-1)) for (ref, _), (lo, _) in pairs]
    tie = ctx.cell.precision["logit_tie"]
    return {"widest_gap": max(gap.served_gap(ref, t) for ref, t in firsts),
            "tokens_not_best": sum(gap.not_best(ref, t, tie) for ref, t in firsts),
            "memory_rel_err": mem, "cross_kv_rel_err": kv}
