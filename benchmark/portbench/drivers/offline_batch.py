"""Batched offline transcription: ``models.moonshine.encode`` and
``decoding.greedy.greedy_decode`` over bucketed batches of a corpus, back
to back in a closed loop.

The corpus is made on the device from the seed: clips of the mix's
lengths (``traffic.clip_lengths``), Gaussian noise, each batch's clips
zero-padded to its bucket in set-up.  Batches follow
``eval/librispeech._buckets`` (128-frame steps), in an order that keeps the
buckets' proportions in every stretch (``traffic.interleave``).  Each clip
decodes to EOS or to its cap of ``tokens_per_second`` a second of audio
(``OfflineBackend``'s rule); a batch to the longest of them.

The traced batch follows the window in every run: a full batch of the
bucket that holds the most batches, its clips picked by length rank, so
that every seed traces clips of the same lengths (the seed draws their
audio) whatever the window got through.  Its device time per audio second
is the cell's end-to-end metric (``metrics/offline_device_ms_per_audio_s.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import flops, gap, traffic
from ..peaks import PEAK_FLOPS
from ..trace import traced
from ..weights import leaf_shapes
from .common import (
    benchmark_weights,
    dtype_of,
    meta_model,
    now,
    program_model,
    sync,
    tuples,
)


def _program():
    from moonshine_tpu_torch.core.config import MoonshineArchConfig
    from moonshine_tpu_torch.decoding import greedy
    from moonshine_tpu_torch.models import moonshine as mm

    return MoonshineArchConfig, greedy, mm


def _weights(ctx) -> dict:
    bf16 = ("",) if ctx.cell.precision["weights"] == "bfloat16" else ()
    return benchmark_weights(ctx.state["shapes"], ctx.seed, ctx.device, bf16)


def setup(ctx) -> None:
    Config, greedy, mm = _program()
    arch, mix, dev = ctx.cell.config["arch"], ctx.cell.traffic, ctx.device
    cfg = Config(**tuples(arch))
    model_meta = meta_model(mm.init_params, cfg)
    ctx.state["shapes"] = leaf_shapes(model_meta)
    model = program_model(model_meta, _weights(ctx), dev)
    mm.prepare_rotary_params(model, cfg, refresh=True)
    model = model.to(dtype_of(ctx.cell.precision))
    ctx.mark("weights and model")
    lengths = traffic.clip_lengths(mix["clips"])
    order = traffic.rng(ctx.seed, 3).permutation(len(lengths))
    batches = traffic.interleave(
        traffic.bucket_batches(arch, lengths, order, mix["batch"], mix["bucket_frames"],
                               mix["max_bucket_frames"]), ctx.seed)
    tps = mix["tokens_per_second"]
    plans, rows = [], {}
    gen = traffic.device_generator(ctx.seed, 1, dev)
    for j, (n, idx) in enumerate(batches):
        lens = np.minimum(lengths[idx], n)  # a clip past its bucket's samples is cut there
        caps = np.maximum((lens / 16000 * tps).astype(np.int64), 1)
        lens_dev = torch.from_numpy(lens).to(dev)
        plans.append({
            "n": int(n), "idx": idx, "lengths": lens, "caps": caps,
            "max_tokens": max(int(n / 16000 * tps), 8),
            "audio": traffic.padded_noise(lens_dev, int(n), mix["clips"]["noise_std"], gen),
            "lengths_dev": lens_dev, "caps_dev": torch.from_numpy(caps).to(dev),
        })
        rows.update((int(i), (j, r)) for r, i in enumerate(idx))
    traced_batches = []
    for idx in traced_clips(plans, lengths, mix["batch"], mix["trace_batches"]):
        at = [rows[int(i)] for i in idx]
        n = plans[at[0][0]]["n"]
        lens = np.minimum(lengths[idx], n)
        caps = np.maximum((lens / 16000 * tps).astype(np.int64), 1)
        traced_batches.append({
            "n": n, "idx": idx, "lengths": lens, "caps": caps,
            "max_tokens": max(int(n / 16000 * tps), 8),
            "audio": torch.stack([plans[j]["audio"][r] for j, r in at]),
            "lengths_dev": torch.from_numpy(lens).to(dev), "caps_dev": torch.from_numpy(caps).to(dev),
        })
    ctx.state.update(cfg=cfg, greedy=greedy, mm=mm, model=model,
                     inputs=[plan["audio"] for plan in plans], rows=rows, plans=plans,
                     traced_batches=traced_batches,
                     kv_int8=ctx.cell.precision["kv_int8"], done=[],
                     memories=gap.Reservoir(traffic.rng(ctx.seed, 7), mix["check_memories"]))
    ctx.mark("corpus and batches")
    # Warm every (batch, samples) shape the batches use: an encode and the
    # first decoder steps over a cache of the batch's size.
    seen = set()
    for plan in plans:
        key = (len(plan["idx"]), plan["n"])
        if key in seen:
            continue
        seen.add(key)
        with torch.inference_mode():
            memory, mask = mm.encode(model, cfg, plan["audio"], plan["lengths_dev"],
                                     attn_impl="auto")
            greedy.greedy_decode(model, cfg, memory, mask, max_tokens=plan["max_tokens"],
                                 token_caps=torch.clamp(plan["caps_dev"], max=2),
                                 kv_int8=ctx.state["kv_int8"])
    sync(dev)
    ctx.mark(f"warm-up of {len(seen)} shapes")


def decoder_calls(lens: np.ndarray, caps: np.ndarray, max_tokens: int) -> int:
    """The decoder calls ``greedy_decode`` makes for a batch: the start
    token's, then one a step until every row has met EOS or its cap."""
    caps = np.minimum(caps, max_tokens)
    k = np.where(lens >= caps, caps - 1, lens)
    return 1 + int(min(k.max(), max_tokens - 1))


def _run_batch(ctx, plan, trace: bool = False, host: bool = True):
    st = ctx.state
    cfg, mm, greedy, model = st["cfg"], st["mm"], st["greedy"], st["model"]
    dev = ctx.device

    def encode():
        return mm.encode(model, cfg, plan["audio"], plan["lengths_dev"], attn_impl="auto")

    def decode():
        res = greedy.greedy_decode(model, cfg, memory, mask, max_tokens=plan["max_tokens"],
                                   token_caps=plan["caps_dev"], kv_int8=st["kv_int8"])
        return res.tokens.cpu().numpy(), res.lengths.cpu().numpy()

    with torch.inference_mode():
        t0 = now()
        if trace:
            (memory, mask), enc_session = traced("encode", encode, host)
        else:
            memory, mask = encode()
            sync(dev)
        t1 = now()
        if trace:
            (tokens, lens), dec_session = traced("decode", decode, host)
        else:
            tokens, lens = decode()
        t2 = now()
    steps = decoder_calls(lens, plan["caps"], plan["max_tokens"])
    out = {"tokens": tokens, "lens": lens, "steps": steps, "t": (t0, t1, t2), "memory": memory}
    if trace:
        arch = ctx.cell.config["arch"]
        frames = [traffic.frames_for_samples(arch, int(k)) for k in plan["lengths"]]
        heads = arch["encoder_heads"]
        f32 = ctx.cell.precision["weights"] == "float32"
        enc_session.info["k1"] = {
            "calls": arch["encoder_layers"], "lengths": frames, "heads": heads,
            "head_dim": arch["hidden_size"] // heads, "elt_bytes": 4 if f32 else 2,
            "peak": PEAK_FLOPS["float32_six_pass" if f32 else "bfloat16"],
            "kernel": "encoder_attention_f32_kernel" if f32 else "encoder_attention_mma_kernel"}
        dec_session.info["steps"] = steps
        out["sessions"] = [enc_session, dec_session]
    return out


def _batch_flops(arch: dict, lengths: np.ndarray, caps: np.ndarray, lens: np.ndarray) -> int:
    """Model FLOPs of a batch's clips of ``lengths`` samples that served
    ``lens`` tokens under ``caps``: each clip's frames, and a decoder
    position for each token served and for the EOS that stopped it."""
    total = 0
    for k, n_tok, cap in zip(lengths, lens, caps):
        frames = traffic.frames_for_samples(arch, int(k))
        forwards = int(n_tok) + (1 if n_tok < cap else 0)
        total += flops.moonshine_encode_flops(arch, int(k))
        total += flops.moonshine_decode_flops(arch, frames, forwards)
    return total


def _keep_memories(ctx, plan, memory) -> None:
    """Offer the batch's clips to the seeded sample whose memories the
    check compares; a kept clip's valid rows are copied."""
    arch = ctx.cell.config["arch"]
    for row, (clip, k) in enumerate(zip(plan["idx"], plan["lengths"])):
        frames = traffic.frames_for_samples(arch, int(k))
        ctx.state["memories"].offer((int(clip), int(k)), int(k),
                                    lambda row=row, f=frames: memory[row, :f].clone())


def window(ctx, seconds: float) -> dict:
    st, rec = ctx.state, ctx.record
    arch = ctx.cell.config["arch"]
    plans = st["plans"]
    audio_s, clips, i = 0.0, 0, 0
    t0 = now()
    while True:
        plan = plans[i % len(plans)]
        out = _run_batch(ctx, plan)
        ta, tb, tc = out["t"]
        rec.span("encode", ta, tb, batch=len(plan["idx"]), samples=plan["n"])
        rec.span("decode", tb, tc, batch=len(plan["idx"]), steps=out["steps"])
        st["done"].append((plan["idx"], plan["lengths"],
                           np.minimum(plan["caps"], plan["max_tokens"]), out["tokens"], out["lens"]))
        _keep_memories(ctx, plan, out["memory"])
        audio_s += float(plan["lengths"].sum()) / 16000
        clips += len(plan["idx"])
        i += 1
        if tc - t0 >= seconds:
            break
    rec.window_s = tc - t0
    model_flops = sum(_batch_flops(arch, samples, caps, lens)
                      for _, samples, caps, _, lens in st["done"])
    rec.counters.update(attempted=clips, failed=0, audio_s=audio_s, model_flops=model_flops,
                        peak_flops=flops.peak_flops(ctx.cell.precision), batches=i)
    return {}


def traced_clips(plans: list, lengths: np.ndarray, batch: int, count: int) -> list:
    """``count`` batches of ``batch`` clips of the bucket that holds the
    most batches (the smallest such bucket): the bucket's clips ranked by
    length, batch b taking every ``count``-th from rank b, and of those
    ``batch`` evenly spaced.  Bucket and lengths are the same for every
    seed; only which clip holds a length follows the seed's order."""
    per: dict[int, int] = {}
    for plan in plans:
        per[plan["n"]] = per.get(plan["n"], 0) + 1
    n = min(per, key=lambda b: (-per[b], b))
    clips = np.concatenate([plan["idx"] for plan in plans if plan["n"] == n])
    ranked = clips[np.lexsort((clips, lengths[clips]))]
    out = []
    for b in range(count):
        pool = ranked[b::count]
        out.append(pool[np.linspace(0, len(pool) - 1, min(batch, len(pool))).round().astype(int)])
    return out


def trace(ctx, host: bool = True) -> None:
    """The traced batches, each clip's audio as the window's batches hold
    it: their device time, work and audio for the metric readers."""
    arch, rec = ctx.cell.config["arch"], ctx.record
    audio_s = model_flops = 0
    for plan in ctx.state["traced_batches"]:
        out = _run_batch(ctx, plan, trace=True, host=host)
        rec.sessions += out["sessions"]
        audio_s += float(plan["lengths"].sum()) / 16000
        model_flops += _batch_flops(arch, plan["lengths"],
                                    np.minimum(plan["caps"], plan["max_tokens"]), out["lens"])
    rec.counters.update(traced_audio_s=audio_s, traced_model_flops=model_flops)


def release(ctx) -> None:
    for key in ("model", "plans", "traced_batches"):
        ctx.state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def checked_clips(ctx) -> list[tuple]:
    """(clip index, its samples, served tokens, stopped on EOS) of a sample
    of the window's clips drawn from the seed, the longest among them."""
    served = [(int(clip), int(k), [int(t) for t in tokens[row, :lens[row]]],
               bool(lens[row] < caps[row]))
              for idx, samples, caps, tokens, lens in ctx.state["done"]
              for row, (clip, k) in enumerate(zip(idx, samples))]
    longest = max(range(len(served)), key=lambda j: served[j][1])
    picked = gap.sample(traffic.rng(ctx.seed, 4), len(served), ctx.cell.traffic["check_clips"],
                        longest)
    return [served[j] for j in picked]


def _reference(ctx, mode: str):
    from reference import moonshine as ref
    from reference.numerics import Products

    return ref, _weights(ctx), Products(mode)


def _clip_audio(ctx, clip: int, k: int) -> torch.Tensor:
    j, row = ctx.state["rows"][clip]
    return ctx.state["inputs"][j][row, :k]


def reference_logits(ctx, clips, mode: str = "float32"):
    """(reference logits, targets) of each checked clip, the reference in
    ``mode`` (``reference.numerics.Products``)."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    dims = ref.decoder_dims(arch)
    out = []
    for clip, k, tokens, stopped in clips:
        memory = ref.encode(w, arch, _clip_audio(ctx, clip, k), p)
        inputs, targets = gap.forced_inputs(arch["decoder_start_token_id"], tokens,
                                            arch["eos_token_id"], stopped)
        logits = ref.forced_logits(w, dims, memory, torch.tensor(inputs, device=ctx.device), p,
                                   ctx.cell.precision["kv_int8"])
        out.append((logits, torch.tensor(targets, device=ctx.device)))
    return out


def reference_memories(ctx, mode: str = "float32") -> list:
    """(the program's memory, the reference's) of each sampled clip."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    return [(memory, ref.encode(w, arch, _clip_audio(ctx, clip, k), p))
            for (clip, k), memory in ctx.state["memories"].sample()]


def check(ctx) -> dict:
    clips = checked_clips(ctx)
    worst = max(gap.served_gap(lg, tg) for lg, tg in reference_logits(ctx, clips))
    memory = max(gap.rel_rms(ours, ref) for ours, ref in reference_memories(ctx))
    ctx.record.counters["checked_tokens"] = sum(len(t) for _, _, t, _ in clips)
    return {"logit_gap": {"value": worst, "limit": ctx.cell.limits.get("logit_gap")},
            "memory_rel_err": {"value": memory, "limit": ctx.cell.limits.get("memory_rel_err")}}


def control(ctx, mode: str) -> dict:
    """The control's numbers: the widest gap of the tokens that the
    reference computed in ``mode`` puts first over the checked clips, and
    its memories' error against the float32 reference's."""
    clips = checked_clips(ctx)
    pairs = zip(reference_logits(ctx, clips), reference_logits(ctx, clips, mode))
    low = reference_memories(ctx, mode)
    return {"logit_gap": max(gap.control_gap(ref, lo) for (ref, _), (lo, _) in pairs),
            "memory_rel_err": max(gap.rel_rms(lo, ref) for (_, ref), (_, lo)
                                  in zip(reference_memories(ctx), low))}
