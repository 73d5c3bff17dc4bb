"""Batched offline transcription with Canary-Qwen, a speech-augmented LLM:
``models.canary_qwen.encode`` (Canary's encoder, the adapter, the
projection) and ``decoding.greedy.greedy_decode`` (each row's prompt of the
prefix ids, its own audio frames and the suffix ids prefilled in one call,
then one token a decoder call) over bucketed batches of a corpus of long
segments, back to back in a closed loop.

The corpus, the batches, the buckets and the traced batch are
``aed_offline``'s (Canary's cell): clips of the mix's lengths, Gaussian
noise made on the device from the seed, each batch zero-padded to its
bucket, the traced batch a full batch of the commonest bucket picked by
length rank.  Each clip decodes to EOS or to its cap of
``tokens_per_second`` a second of audio.

The check reads the timed entry at its size: the window's audio
embeddings (after the projection) of a sample of its clips, and one window
batch run again through ``encode`` and ``greedy_decode`` (the batch of the
sample's longest clip), from which it keeps, for some of its rows, the
audio embeddings as ``greedy_decode`` spliced them into the row's prompt
(read by a wrapper on ``model.prompt_embeds``: so a splice that takes the
wrong frames shows beside an encoder that computes them wrong) and the
logits as its own decoder calls computed them: the prompt's last position,
then one a served token; the first encoder layer's relative-position
attention with its position projection scaled (Canary's probe,
``aed_offline.POS_PROBE_SCALE``: the audio embeddings alone do not see a
misaligned position term); and the same logits of that batch run once more
with every LLM layer's q gain scaled (``ROPE_PROBE_SCALE``, the rotary
probe), against the reference with the same gains.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from .. import flops, flops_aed, flops_salm, gap, traffic
from ..launches import traced_launches
from ..weights import leaf_shapes
from .aed_offline import POS_PROBE_SCALE, _forced_inputs, _plan, bucket_batches
from .common import benchmark_weights, dtype_of, meta_model, now, program_model, sync, tuples
from .offline_batch import checked_clips, decoder_calls, traced_clips


# The rotary probe's scale of every LLM layer's q_norm gain.  The
# benchmark's random weights leave the LLM's attention nearly flat (logits
# of std about 1 over a few hundred keys), where a position off by one
# moves the logits by about as much as bf16's own error.  With the q
# gains scaled (a power of 2: exact in bf16), the attention follows the
# rotary phases, so the check sees a misaligned position.
ROPE_PROBE_SCALE = 4.0


def _program():
    from moonshine_tpu_torch.decoding import greedy
    from moonshine_tpu_torch.models import canary_qwen

    return greedy, canary_qwen


def _weights(ctx) -> dict:
    bf16 = ("",) if ctx.cell.precision["weights"] == "bfloat16" else ()
    return benchmark_weights(ctx.state["shapes"], ctx.seed, ctx.device, bf16)


def _frames(arch: dict, n_samples: int) -> int:
    return flops_aed.frames(arch, n_samples)[-1]


def setup(ctx) -> None:
    greedy, cq = _program()
    arch, mix, dev = ctx.cell.config["arch"], ctx.cell.traffic, ctx.device
    cfg = cq.CanaryQwenArchConfig(**tuples(arch))
    model_meta = meta_model(cq.init_params, cfg)
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
    ctx.state.update(cfg=cfg, greedy=greedy, cq=cq, model=model,
                     inputs=[plan["audio"] for plan in plans], rows=rows, plans=plans,
                     traced_batches=traced_batches, kv_int8=ctx.cell.precision["kv_int8"],
                     done=[], memories=gap.Reservoir(traffic.rng(ctx.seed, 7),
                                                     mix["check_memories"]))
    ctx.mark("corpus and batches")
    # Warm every (batch, samples) shape the batches use: an encode, the
    # prompt's call and the first decoder calls over a cache of the batch's size.
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
    cfg, cq, greedy, model = st["cfg"], st["cq"], st["greedy"], st["model"]

    def encode():
        return cq.encode(model, cfg, plan["audio"], plan["lengths_dev"])

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
        elt_bytes = 4 if ctx.cell.precision["weights"] == "float32" else 2
        # Canary's encoder and the adapter: one relative-position attention a layer.
        enc_session.info["relpos"] = {
            "lengths": [_frames(arch, int(k)) for k in plan["lengths"]],
            "calls": arch["encoder_layers"] + arch["adapter_layers"],
            "d_model": arch["d_model"], "elt_bytes": elt_bytes}
        dec_session.info["steps"] = steps
        dec_session.info["salm"] = {
            "arch": arch, "prompt_lengths": [flops_salm.prompt_length(arch, int(k))
                                             for k in plan["lengths"]],
            "elt_bytes": elt_bytes}
        out["sessions"] = [enc_session, dec_session]
    return out


def _batch_flops(arch: dict, lengths, caps, lens) -> int:
    """Model FLOPs of clips of ``lengths`` samples that served ``lens``
    tokens under ``caps``: each clip's encode, its prompt, and a position
    for each token served and for the EOS that stopped it."""
    total = 0
    for k, n_tok, cap in zip(lengths, lens, caps):
        forwards = int(n_tok) + (1 if n_tok < cap else 0)
        total += flops_salm.encode_flops(arch, int(k)) + flops_salm.decode_flops(arch, int(k),
                                                                                 forwards)
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
            f = _frames(arch, int(k))
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


@contextlib.contextmanager
def _sharpened(model):
    """Every LLM layer's q_norm gain times ``ROPE_PROBE_SCALE`` inside."""
    gains = [lp.q_norm.weight for lp in model.decoder.layers]
    with torch.no_grad():
        for g in gains:
            g.mul_(ROPE_PROBE_SCALE)
    try:
        yield
    finally:
        with torch.no_grad():
            for g in gains:
                g.div_(ROPE_PROBE_SCALE)


def _recorded_run(ctx, plan, picked, pos_probe: bool = False):
    """``plan`` run through ``encode`` and ``greedy_decode``; returns (the
    run, [rows, decoder calls, V] the logits its decoder calls computed,
    [rows, P, D] the prompts ``prompt_embeds`` spliced, and with
    ``pos_probe`` [rows, frames, D] the first encoder layer's attention over
    its own input with its position projection times ``POS_PROBE_SCALE``,
    else None) of the rows ``picked``."""
    model = ctx.state["model"]
    logits, prompts, probes = [], [], []
    decoder_apply, prompt_embeds = model.decoder_apply, model.prompt_embeds
    attn = model.encoder.layers[0].attn
    hook = None
    if pos_probe:
        probe = copy.deepcopy(attn)
        with torch.no_grad():
            probe.pos.weight.mul_(POS_PROBE_SCALE)
        hook = attn.register_forward_hook(
            lambda module, args, out: probes.append(probe(*args[:4])[picked]))

    def recorded(cfg, inputs, cache, **kw):
        out = decoder_apply(cfg, inputs, cache, **kw)
        logits.append(out[0][picked, -1].float())
        return out

    def spliced(cfg, memory, mask):
        out = prompt_embeds(cfg, memory, mask)
        prompts.append(out[0][picked])
        return out

    model.decoder_apply, model.prompt_embeds = recorded, spliced
    try:
        out = _run_batch(ctx, plan)
    finally:
        del model.decoder_apply, model.prompt_embeds
        if hook is not None:
            hook.remove()
    return out, torch.stack(logits, 1), prompts[0], probes[0] if probes else None


def _rerun(ctx) -> list:
    """The window batch that holds the memory sample's longest clip, run
    again through ``encode`` and ``greedy_decode`` as the window ran it,
    and once more with the rotary probe (``_sharpened``).  Returns, for
    that clip and ``check_memories`` more rows of the batch drawn from the
    seed, ((clip, samples), {"logits": [targets, V] the logits
    ``greedy_decode``'s decoder calls computed (the prompt's last position,
    then one a call), "audio": [F, D] the audio embeddings between the
    prompt's ids as ``prompt_embeds`` spliced them, "tokens": the served
    tokens, "stopped": on EOS, "pos_probe": [F, D] the encoder's position
    probe (``_recorded_run``), "probe": the first three of the rotary
    probe's run})."""
    st = ctx.state
    _, (longest, _), _ = st["memories"].longest
    j, row = st["rows"][longest]
    plan = st["plans"][j]
    others = [r for r in range(len(plan["idx"])) if r != row]
    n = min(ctx.cell.traffic["check_memories"], len(others))
    rows = [row] + sorted(traffic.rng(ctx.seed, 11).choice(others, n, replace=False).tolist())
    picked = torch.tensor(rows, device=ctx.device)
    out, steps, prompts, pos_probes = _recorded_run(ctx, plan, picked, pos_probe=True)
    with _sharpened(st["model"]):
        p_out, p_steps, _, _ = _recorded_run(ctx, plan, picked)
    caps = np.minimum(plan["caps"], plan["max_tokens"])
    arch = ctx.cell.config["arch"]
    end = prompts.shape[1] - len(arch["prompt_suffix_ids"])  # every prompt ends at the last column

    def served(run, logits, i, r):
        n_tok = int(run["lens"][r])
        stopped = n_tok < caps[r]
        return {"logits": logits[i, :n_tok + stopped],
                "tokens": [int(t) for t in run["tokens"][r, :n_tok]], "stopped": bool(stopped)}

    checked = []
    for i, r in enumerate(rows):
        k = int(plan["lengths"][r])
        f = _frames(arch, k)
        checked.append(((int(plan["idx"][r]), k),
                        dict(served(out, steps, i, r), audio=prompts[i, end - f:end],
                             pos_probe=pos_probes[i, :f], probe=served(p_out, p_steps, i, r))))
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
    from reference import canary_qwen as ref
    from reference.numerics import Products

    return ref, _weights(ctx), Products(mode)


def _reference_pos_probe(ctx, w, p, audio) -> torch.Tensor:
    """Canary's reference of the encoder's position probe."""
    from reference import canary as enc

    return enc.attention_probe(w, ctx.cell.config["arch"], audio, p, POS_PROBE_SCALE)


def _forced(ctx, ref, w, p, audio, tokens: list, stopped: bool):
    """(the reference's logits over the clip's prompt and the served tokens:
    row 0 at the prompt's last position, each later row at a fed-back
    token (``aed_offline._forced_inputs``, the prompt being one position);
    its audio embeddings)."""
    arch = ctx.cell.config["arch"]
    inputs, _ = _forced_inputs([None], tokens, stopped, arch["eos_token_id"])
    emb = ref.audio_embeddings(w, arch, audio, p)
    fed = torch.tensor(inputs[1:], dtype=torch.long, device=ctx.device)
    return ref.forced_logits(w, arch, emb, fed, p, ctx.cell.precision["kv_int8"]), emb


def reference_logits(ctx, clips, mode: str = "float32"):
    """(reference logits, targets) of each checked clip, the reference in
    ``mode`` (``reference.numerics.Products``) over the prompt and the
    served tokens."""
    ref, w, p = _reference(ctx, mode)
    eos = ctx.cell.config["arch"]["eos_token_id"]
    out = []
    for clip, k, tokens, stopped in clips:
        _, targets = _forced_inputs([None], list(tokens), stopped, eos)
        logits, _ = _forced(ctx, ref, w, p, _clip_audio(ctx, clip, k), list(tokens), stopped)
        out.append((logits, torch.tensor(targets, device=ctx.device)))
    return out


def reference_memories(ctx, mode: str = "float32") -> list:
    """The reference's audio embeddings of each clip of the memory sample,
    the reference in ``mode``."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    return [ref.audio_embeddings(w, arch, _clip_audio(ctx, clip, k), p)
            for (clip, k), _ in ctx.state["memories"].sample()]


def reference_rerun(ctx, mode: str = "float32") -> list:
    """(the reference's logits as ``_rerun`` keeps them, over the rerun's
    served tokens; its audio embeddings; its logits with the rotary probe's
    gains over the probe's served tokens; its encoder's position probe) of
    each clip of the rerun, the reference in ``mode``."""
    ref, w, p = _reference(ctx, mode)
    arch = ctx.cell.config["arch"]
    sharp = dict(w, **{f"decoder.layers.{i}.q_norm.weight":
                       w[f"decoder.layers.{i}.q_norm.weight"] * ROPE_PROBE_SCALE
                       for i in range(arch["llm_layers"])})
    out = []
    for (clip, k), got in ctx.state["rerun"]:
        audio = _clip_audio(ctx, clip, k)
        logits, emb = _forced(ctx, ref, w, p, audio, got["tokens"], got["stopped"])
        probe = got["probe"]
        probe_logits, _ = _forced(ctx, ref, sharp, p, audio, probe["tokens"], probe["stopped"])
        out.append((logits, emb, probe_logits, _reference_pos_probe(ctx, w, p, audio)))
    return out


def check(ctx) -> dict:
    clips = checked_clips(ctx)
    worst = max(gap.served_gap(lg, tg) for lg, tg in reference_logits(ctx, clips))
    memory = max(gap.rel_rms(m, r) for (_, m), r in zip(ctx.state["memories"].sample(),
                                                         reference_memories(ctx)))
    pairs = list(zip(ctx.state["rerun"], reference_rerun(ctx)))
    memory = max([memory] + [gap.rel_rms(got["audio"], emb) for (_, got), (_, emb, _, _) in pairs])
    logit = max(gap.rel_rms(got["logits"], lg) for (_, got), (lg, _, _, _) in pairs)
    probe = max(gap.rel_rms(got["probe"]["logits"], pr) for (_, got), (_, _, pr, _) in pairs)
    pos = max(gap.rel_rms(got["pos_probe"], pp) for (_, got), (_, _, _, pp) in pairs)
    ctx.record.counters["checked_tokens"] = sum(len(t) for _, _, t, _ in clips)
    limits = ctx.cell.limits
    numbers = {"logit_gap": worst, "audio_embed_rel_err": memory, "logit_rel_err": logit,
               "rope_probe_rel_err": probe, "relpos_probe_rel_err": pos}
    return {name: {"value": value, "limit": limits.get(name)} for name, value in numbers.items()}


def control(ctx, mode: str) -> dict:
    """The control's numbers: the widest gap of the tokens that the
    reference computed in ``mode`` puts first over the checked clips, and
    its audio embeddings', logits' and probes' errors against the float32
    reference's."""
    clips = checked_clips(ctx)
    pairs = zip(reference_logits(ctx, clips), reference_logits(ctx, clips, mode))
    reruns = list(zip(reference_rerun(ctx), reference_rerun(ctx, mode)))
    memories = zip(reference_memories(ctx), reference_memories(ctx, mode))
    return {"logit_gap": max(gap.control_gap(r, lo) for (r, _), (lo, _) in pairs),
            "audio_embed_rel_err": max([gap.rel_rms(lm, rm) for rm, lm in memories]
                                       + [gap.rel_rms(le, re)
                                          for (_, re, _, _), (_, le, _, _) in reruns]),
            "logit_rel_err": max(gap.rel_rms(ll, rl) for (rl, _, _, _), (ll, _, _, _) in reruns),
            "rope_probe_rel_err": max(gap.rel_rms(lp, rp)
                                      for (_, _, rp, _), (_, _, lp, _) in reruns),
            "relpos_probe_rel_err": max(gap.rel_rms(lq, rq)
                                        for (_, _, _, rq), (_, _, _, lq) in reruns)}
