"""Batched offline transcription with Canary: ``models.canary.encode`` and
``decoding.greedy.greedy_decode`` (the task prompt prefilled, then one
token a decoder call) over bucketed batches of a corpus of long segments,
back to back in a closed loop.

The corpus is made on the device from the seed: clips of the mix's
lengths (``traffic.clip_lengths``), Gaussian noise, each batch's clips
zero-padded to its bucket of ``bucket_samples`` steps in set-up, batches of
``batch`` clips in an order that keeps the buckets' proportions in every
stretch (``traffic.interleave``).  Each clip decodes to EOS or to its cap
of ``tokens_per_second`` a second of audio; a batch to the longest of them.

The traced batch follows the window in every run: a full batch of the
bucket that holds the most batches, its clips picked by length rank
(``offline_batch.traced_clips``), so that every seed traces clips of the
same lengths.  Its device time per audio second is the cell's end-to-end
metric; its device operations carry their launches
(``launches.traced_launches``), which the per-layer readers set against
the program's spans.

The check reads the timed entry at its size: the window's memories of a
sample of its clips, and one window batch run again through ``encode``
and ``greedy_decode`` (the batch of the sample's longest clip), from which
it keeps the decoder logits of some of its rows as ``greedy_decode``
computed them and a probe of the first encoder layer's relative-position
attention (``POS_PROBE_SCALE``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import flops, flops_aed, gap, traffic
from ..launches import traced_launches
from ..weights import leaf_shapes
from .common import benchmark_weights, dtype_of, meta_model, now, program_model, sync, tuples
from .offline_batch import checked_clips, decoder_calls, traced_clips


# The probe's scale of the position projection.  The benchmark's random
# weights leave the encoder's attention nearly uniform (logits of std about
# 0.33), where the relative-position term moves the attention's output by
# less than bf16's own error.  Scaled by 16, the position term's logits have
# a std of about 4.5, so the attention follows relative position and a
# dropped or misaligned term moves the output by 25-35 times bf16's error.
POS_PROBE_SCALE = 16.0


def _program():
    from moonshine_tpu_torch.decoding import greedy
    from moonshine_tpu_torch.models import canary

    return greedy, canary


def _weights(ctx) -> dict:
    bf16 = ("",) if ctx.cell.precision["weights"] == "bfloat16" else ()
    return benchmark_weights(ctx.state["shapes"], ctx.seed, ctx.device, bf16)


def bucket_batches(lengths: np.ndarray, order: np.ndarray, batch: int, step: int,
                   largest: int) -> list[tuple[int, np.ndarray]]:
    """Clips grouped into buckets of ``step``-sample steps up to ``largest``
    (which takes every longer clip), ``batch`` to a batch in ``order``
    within a bucket.  Returns (padded samples, clip indices) per batch,
    bucket by bucket."""
    groups: dict[int, list[int]] = {}
    for i in order:
        n = min(-(-int(lengths[i]) // step) * step, largest)
        groups.setdefault(n, []).append(int(i))
    return [(n, np.asarray(items[j:j + batch]))
            for n, items in sorted(groups.items()) for j in range(0, len(items), batch)]


def _plan(n: int, idx: np.ndarray, lengths: np.ndarray, tps: float, audio, dev) -> dict:
    lens = np.minimum(lengths[idx], n)  # a clip past its bucket's samples is cut there
    caps = np.maximum((lens / traffic.SAMPLE_RATE * tps).astype(np.int64), 1)
    return {"n": int(n), "idx": idx, "lengths": lens, "caps": caps,
            "max_tokens": max(int(n / traffic.SAMPLE_RATE * tps), 8), "audio": audio,
            "lengths_dev": torch.from_numpy(lens).to(dev), "caps_dev": torch.from_numpy(caps).to(dev)}


def setup(ctx) -> None:
    greedy, canary = _program()
    arch, mix, dev = ctx.cell.config["arch"], ctx.cell.traffic, ctx.device
    cfg = canary.CanaryArchConfig(**tuples(arch))
    model_meta = meta_model(canary.init_params, cfg)
    ctx.state["shapes"] = leaf_shapes(model_meta)
    model = program_model(model_meta, _weights(ctx), dev).to(dtype_of(ctx.cell.precision))
    ctx.mark("weights and model")
    lengths = traffic.clip_lengths(mix["clips"])
    order = traffic.rng(ctx.seed, 3).permutation(len(lengths))
    batches = traffic.interleave(bucket_batches(lengths, order, mix["batch"],
                                                mix["bucket_samples"], mix["max_bucket_samples"]),
                                 ctx.seed)
    tps = mix["tokens_per_second"]
    gen = traffic.device_generator(ctx.seed, 1, dev)
    plans, rows = [], {}
    for j, (n, idx) in enumerate(batches):
        lens_dev = torch.from_numpy(np.minimum(lengths[idx], n)).to(dev)
        audio = traffic.padded_noise(lens_dev, int(n), mix["clips"]["noise_std"], gen)
        plans.append(_plan(n, idx, lengths, tps, audio, dev))
        rows.update((int(i), (j, r)) for r, i in enumerate(idx))
    traced_batches = []
    for idx in traced_clips(plans, lengths, mix["batch"], mix["trace_batches"]):
        at = [rows[int(i)] for i in idx]
        audio = torch.stack([plans[j]["audio"][r] for j, r in at])
        traced_batches.append(_plan(plans[at[0][0]]["n"], idx, lengths, tps, audio, dev))
    ctx.state.update(cfg=cfg, greedy=greedy, canary=canary, model=model,
                     inputs=[plan["audio"] for plan in plans], rows=rows, plans=plans,
                     traced_batches=traced_batches, kv_int8=ctx.cell.precision["kv_int8"],
                     done=[], memories=gap.Reservoir(traffic.rng(ctx.seed, 7),
                                                     mix["check_memories"]))
    ctx.mark("corpus and batches")
    # Warm every (batch, samples) shape the batches use: an encode and the
    # first decoder calls over a cache of the batch's size.
    seen = set()
    for plan in plans:
        key = (len(plan["idx"]), plan["n"])
        if key not in seen:
            seen.add(key)
            _run_batch(ctx, dict(plan, caps_dev=torch.clamp(plan["caps_dev"], max=2)))
    sync(dev)
    ctx.mark(f"warm-up of {len(seen)} shapes")


def _run_batch(ctx, plan, trace: bool = False, host: bool = True):
    st = ctx.state
    cfg, canary, greedy, model = st["cfg"], st["canary"], st["greedy"], st["model"]

    def encode():
        return canary.encode(model, cfg, plan["audio"], plan["lengths_dev"])

    def decode():
        res = greedy.greedy_decode(model, cfg, memory, mask, max_tokens=plan["max_tokens"],
                                   token_caps=plan["caps_dev"], kv_int8=st["kv_int8"])
        return res.tokens.cpu().numpy(), res.lengths.cpu().numpy()

    with torch.inference_mode():
        t0 = now()
        if trace:
            (memory, mask), enc_session = traced_launches("encode", encode, host)
        else:
            memory, mask = encode()
            sync(ctx.device)
        t1 = now()
        if trace:
            (tokens, lens), dec_session = traced_launches("decode", decode, host)
        else:
            tokens, lens = decode()
        t2 = now()
    steps = decoder_calls(lens, plan["caps"], plan["max_tokens"])
    out = {"tokens": tokens, "lens": lens, "steps": steps, "t": (t0, t1, t2), "memory": memory}
    if trace:
        arch = ctx.cell.config["arch"]
        enc_session.info["relpos"] = {
            "lengths": [flops_aed.frames(arch, int(k))[-1] for k in plan["lengths"]],
            "calls": arch["encoder_layers"], "d_model": arch["d_model"],
            "elt_bytes": 4 if ctx.cell.precision["weights"] == "float32" else 2}
        dec_session.info["steps"] = steps
        out["sessions"] = [enc_session, dec_session]
    return out


def _batch_flops(arch: dict, lengths, caps, lens) -> int:
    """Model FLOPs of clips of ``lengths`` samples that served ``lens``
    tokens under ``caps``: each clip's frames, its prompt, and a decoder
    call for each token served and for the EOS that stopped it."""
    total = 0
    for k, n_tok, cap in zip(lengths, lens, caps):
        forwards = int(n_tok) + (1 if n_tok < cap else 0)
        total += flops_aed.encode_flops(arch, int(k))
        total += flops_aed.decode_flops(arch, flops_aed.frames(arch, int(k))[-1],
                                        len(arch["prompt_ids"]), forwards)
    return total


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
        caps = np.minimum(plan["caps"], plan["max_tokens"])
        st["done"].append((plan["idx"], plan["lengths"], caps, out["tokens"], out["lens"]))
        for row, (clip, k) in enumerate(zip(plan["idx"], plan["lengths"])):
            f = flops_aed.frames(arch, int(k))[-1]
            st["memories"].offer((int(clip), int(k)), int(k),
                                 lambda row=row, f=f: out["memory"][row, :f].clone())
        audio_s += float(plan["lengths"].sum()) / traffic.SAMPLE_RATE
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


def trace(ctx, host: bool = True) -> None:
    """The traced batches, each clip's audio as the window's batches hold
    it: their device time, work and audio for the metric readers."""
    arch, rec = ctx.cell.config["arch"], ctx.record
    audio_s = model_flops = 0
    for plan in ctx.state["traced_batches"]:
        out = _run_batch(ctx, plan, trace=True, host=host)
        rec.sessions += out["sessions"]
        audio_s += float(plan["lengths"].sum()) / traffic.SAMPLE_RATE
        model_flops += _batch_flops(arch, plan["lengths"],
                                    np.minimum(plan["caps"], plan["max_tokens"]), out["lens"])
    rec.counters.update(traced_audio_s=audio_s, traced_model_flops=model_flops)


def _forced_inputs(prompt: list, tokens: list, stopped: bool, eos: int) -> tuple[list, list]:
    """(decoder input, targets): the prompt and the served tokens, each row
    from the prompt's last on scoring the served token after it, and EOS
    where the program stopped on it."""
    targets = tokens + ([eos] if stopped else [])
    return (prompt + tokens)[:len(prompt) - 1 + len(targets)], targets


def _rerun(ctx) -> list:
    """The window batch that holds the memory sample's longest clip, run
    again through ``encode`` and ``greedy_decode`` as the window ran it.
    Returns, for that clip and ``check_memories`` more rows of the batch
    drawn from the seed, ((clip, samples), {"logits": [targets, V] the
    decoder logits ``greedy_decode`` computed (the prompt's last row, then
    one a decoder call), "tokens": the served tokens, "stopped": on EOS,
    "probe": [frames, D] the first encoder layer's attention over its own
    input with its position projection scaled by ``POS_PROBE_SCALE``})."""
    st = ctx.state
    model = st["model"]
    _, (longest, _), _ = st["memories"].longest
    j, row = st["rows"][longest]
    plan = st["plans"][j]
    others = [r for r in range(len(plan["idx"])) if r != row]
    n = min(ctx.cell.traffic["check_memories"], len(others))
    rows = [row] + sorted(traffic.rng(ctx.seed, 11).choice(others, n, replace=False).tolist())
    picked = torch.tensor(rows, device=ctx.device)
    attn = model.encoder.layers[0].attn
    probe = copy.deepcopy(attn)
    with torch.no_grad():
        probe.pos.weight.mul_(POS_PROBE_SCALE)
    probes, logits = [], []
    decoder_apply = model.decoder_apply

    def recorded(cfg, tokens, cache):
        out = decoder_apply(cfg, tokens, cache)
        logits.append(out[0][picked, -1].float())
        return out

    hook = attn.register_forward_hook(
        lambda module, args, out: probes.append(probe(*args[:4])[picked]))
    model.decoder_apply = recorded
    try:
        out = _run_batch(ctx, plan)
    finally:
        hook.remove()
        del model.decoder_apply
    steps = torch.stack(logits, 1)  # [rows, decoder calls, V]
    caps = np.minimum(plan["caps"], plan["max_tokens"])
    arch = ctx.cell.config["arch"]
    checked = []
    for i, r in enumerate(rows):
        n_tok = int(out["lens"][r])
        stopped = n_tok < caps[r]
        k = int(plan["lengths"][r])
        frames = flops_aed.frames(arch, k)[-1]
        checked.append(((int(plan["idx"][r]), k),
                        {"logits": steps[i, :n_tok + stopped],
                         "tokens": [int(t) for t in out["tokens"][r, :n_tok]],
                         "stopped": bool(stopped), "probe": probes[0][i, :frames]}))
    return checked


def release(ctx) -> None:
    ctx.state["rerun"] = _rerun(ctx)
    for key in ("model", "plans", "traced_batches"):
        ctx.state.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _clip_audio(ctx, clip: int, k: int) -> torch.Tensor:
    j, row = ctx.state["rows"][clip]
    return ctx.state["inputs"][j][row, :k]


def _reference(ctx, mode: str):
    from reference import canary as ref
    from reference.numerics import Products

    return ref, _weights(ctx), Products(mode)


def reference_logits(ctx, clips, mode: str = "float32"):
    """(reference logits, targets) of each checked clip: the reference in
    ``mode`` (``reference.numerics.Products``) over the prompt and the
    served tokens (``_forced_inputs``)."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    prompt = list(arch["prompt_ids"])
    out = []
    for clip, k, tokens, stopped in clips:
        memory = ref.encode(w, arch, _clip_audio(ctx, clip, k), p)
        inputs, targets = _forced_inputs(prompt, list(tokens), stopped, arch["eos_token_id"])
        logits = ref.forced_logits(w, arch, memory, torch.tensor(inputs, device=ctx.device), p,
                                   ctx.cell.precision["kv_int8"])
        out.append((logits[len(prompt) - 1:], torch.tensor(targets, device=ctx.device)))
    return out


def reference_memories(ctx, mode: str = "float32") -> list:
    """The reference's memory of each clip of the memory sample, the
    reference in ``mode``."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    return [ref.encode(w, arch, _clip_audio(ctx, clip, k), p)
            for (clip, k), _ in ctx.state["memories"].sample()]


def reference_rerun(ctx, mode: str = "float32") -> list:
    """(reference logits as ``_rerun`` keeps them, over the rerun's served
    tokens; the reference's attention probe) of each clip of the rerun, the
    reference in ``mode``."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    prompt = list(arch["prompt_ids"])
    out = []
    for (clip, k), got in ctx.state["rerun"]:
        audio = _clip_audio(ctx, clip, k)
        inputs, _ = _forced_inputs(prompt, got["tokens"], got["stopped"], arch["eos_token_id"])
        logits = ref.forced_logits(w, arch, ref.encode(w, arch, audio, p),
                                   torch.tensor(inputs, device=ctx.device), p,
                                   ctx.cell.precision["kv_int8"])
        out.append((logits[len(prompt) - 1:],
                    ref.attention_probe(w, arch, audio, p, POS_PROBE_SCALE)))
    return out


def check(ctx) -> dict:
    clips = checked_clips(ctx)
    worst = max(gap.served_gap(lg, tg) for lg, tg in reference_logits(ctx, clips))
    memory = max(gap.rel_rms(m, r) for (_, m), r in zip(ctx.state["memories"].sample(),
                                                         reference_memories(ctx)))
    pairs = list(zip(ctx.state["rerun"], reference_rerun(ctx)))
    ctx.record.counters["checked_tokens"] = sum(len(t) for _, _, t, _ in clips)
    limits = ctx.cell.limits
    numbers = {"logit_gap": worst, "memory_rel_err": memory,
               "logit_rel_err": max(gap.rel_rms(got["logits"], lg) for (_, got), (lg, _) in pairs),
               "relpos_probe_rel_err": max(gap.rel_rms(got["probe"], pr)
                                           for (_, got), (_, pr) in pairs)}
    return {name: {"value": value, "limit": limits.get(name)} for name, value in numbers.items()}


def control(ctx, mode: str) -> dict:
    """The control's numbers: the widest gap of the tokens that the
    reference computed in ``mode`` puts first over the checked clips, and
    its memories', logits' and attention probes' errors against the float32
    reference's."""
    clips = checked_clips(ctx)
    pairs = zip(reference_logits(ctx, clips), reference_logits(ctx, clips, mode))
    reruns = list(zip(reference_rerun(ctx), reference_rerun(ctx, mode)))
    return {"logit_gap": max(gap.control_gap(r, lo) for (r, _), (lo, _) in pairs),
            "memory_rel_err": max(gap.rel_rms(lm, rm) for rm, lm in
                                  zip(reference_memories(ctx), reference_memories(ctx, mode))),
            "logit_rel_err": max(gap.rel_rms(ll, rl) for (rl, _), (ll, _) in reruns),
            "relpos_probe_rel_err": max(gap.rel_rms(lp, rp) for (_, rp), (_, lp) in reruns)}
