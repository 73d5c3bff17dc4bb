#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moonshine_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 64] [--beam-batch 128]

Run from the root of a checkout.  It builds the port's CUDA kernels from
the sources in the checkout, holds each kernel against its plain PyTorch
version on the card, times it beside its bound and PyTorch's own call for
the same function, drives the offline transcription path through
``Transcriber(model="base")`` with random weights (and once with word
timestamps), checks the card's forward and beam search against the CPU's,
and runs the bench's batched offline decodes of Moonshine Base (bf16, int8
KV, 9.26 s clips): greedy, and beam 4 over 128 clips.  Last it runs the
LibriSpeech eval harness with beam 4 on a synthetic corpus.  Every phase
that fails ends the run with a non-zero exit.  The last two lines of
standard output are the kernels' JSON summary and the device JSON; a
fuller record goes to chiprun_out/chip_smoke.json.  Without CUDA, or
without the rest of the repository beside it, it fails before printing
any result.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Data-sheet peaks of one H100 SXM (used for the bound, not measured).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel against its plain version, (atol, rtol).  Both round the weights
# and the output to the I/O dtype at the same points and differ only in
# float32 summation order, so bf16 outputs may differ by about one rounding
# step: rtol 8e-3 covers one bf16 step (at most 2^-7 relative) at any
# magnitude, and atol 4e-3 (twice the largest difference seen on an H100,
# 1.95e-3) covers outputs near zero, where rtol allows nothing.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (4e-3, 8e-3)}
BATCHED_SECONDS = 9.26  # the bench's clip: T=384 encoder frames
SAMPLE_RATE = 16000
BEAM_SIZE = 4  # the bench's offline-beam phase: beam 4, 128 clips
L2_BYTES = 50 * 2**20


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 2, runs: int = 7, before=None) -> float:
    """Median of ``runs`` CUDA-event timings of one call each, after warm-up;
    ``before`` runs ahead of each timed call, outside the timing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if before is not None:
            before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b, t, h, hd, dtype, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    d = h * hd
    q, kt, v = (torch.randn(s, generator=g).to("cuda", dtype)
                for s in ((b, t, d), (b, d, t), (b, t, d)))
    mask = None
    if lengths is not None:
        mask = (torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]).cuda()
    return q, kt, v, mask


def phase_kernel_vs_plain(ea) -> float:
    """K1 against its plain version on the card; returns the largest error."""
    worst = 0.0
    # Base at the bench's T (and T=415), Tiny's hd=36, and the shapes the
    # Transcriber gives it: one segment padded to its 2 s or 16 s bucket.
    cases = [(16, 384, 8, 52, m) for m in (False, True)] + [
        (4, 415, 8, 52, True), (4, 384, 8, 36, True), (1, 83, 8, 52, True),
        (1, 666, 8, 52, True)]
    for b, t, h, hd, masked in cases:
        if not masked:
            lengths = None
        elif b == 1:
            lengths = [t * 3 // 4]  # a segment shorter than its bucket
        else:  # ragged lengths, the last row with no valid key at all
            lengths = [max(t - i * (t // b), 1) for i in range(b - 1)] + [0]
        for dtype in (torch.float32, torch.bfloat16):
            q, kt, v, mask = attention_inputs(b, t, h, hd, dtype, lengths, seed=b + t + hd)
            out = ea.encoder_attention_packed(q, kt, v, mask, h)
            torch.cuda.synchronize()
            ref = ea._encoder_attention_packed_torch(q, kt, v, mask, h)
            err = (out.float() - ref.float()).abs()
            atol, rtol = TOL[dtype]
            ok = bool((err <= atol + rtol * ref.float().abs()).all()) and bool(out.isfinite().all())
            worst = max(worst, float(err.max()))
            log(f"  K1 B={b} T={t} H={h} hd={hd} {str(dtype)[6:]:8s} "
                f"{'masked' if masked else 'unmasked':8s} max_abs_err={float(err.max()):.3e} "
                f"tol=atol {atol:g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K1 disagrees with its plain version at B={b} T={t} hd={hd}")
    return worst


def phase_kernel_times(ea) -> dict:
    """K1, its plain version and SDPA at the bench shape (Base, bf16)."""
    b, t, h, hd = 512, 384, 8, 52
    dtype = torch.bfloat16
    q, kt, v, _ = attention_inputs(b, t, h, hd, dtype, None, seed=1)
    kernel_ms = cuda_time_ms(lambda: ea.encoder_attention_packed(q, kt, v, None, h))
    plain_ms = cuda_time_ms(lambda: ea._encoder_attention_packed_torch(q, kt, v, None, h))
    # PyTorch's own attention on the same inputs (head-split views and an
    # additive -1e9 float key mask): the yardstick only, never the port's path.
    qs = q.view(b, t, h, hd).transpose(1, 2)
    ks = kt.view(b, h, hd, t).transpose(2, 3)
    vs = v.view(b, t, h, hd).transpose(1, 2)
    add_mask = torch.zeros((b, 1, 1, t), device="cuda", dtype=dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(qs, ks, vs, attn_mask=add_mask))
    bytes_moved = 4 * b * t * h * hd * q.element_size()  # q, kt, v read; out written
    flops = 4 * b * h * t * t * hd
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    res = {"shape": [b, t, h, hd], "dtype": "bfloat16", "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bytes": bytes_moved,
           "flops": flops, "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    log(f"  K1 at B={b} T={t} H={h} hd={hd} bf16: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    return res


def gather_inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        pair = (torch.randint(-128, 128, shape, generator=g, dtype=torch.int8) for _ in range(2))
    else:
        pair = (torch.randn(shape, generator=g).to(dtype) for _ in range(2))
    return tuple(x.cuda() for x in pair)


def parent_vectors(n: int, seed: int) -> dict:
    """Parent rows of a beam reorder over ``n`` = utterances x beam rows:
    random parents inside each utterance's beams (duplicates and dropped
    rows), a random permutation inside each utterance's beams (every row
    read once), the identity and the reverse, int32 on the card."""
    g = torch.Generator().manual_seed(seed)
    k = BEAM_SIZE if n % BEAM_SIZE == 0 else 1
    base = torch.arange(n) // k * k
    beams = base + torch.randint(0, k, (n,), generator=g)
    perm = base + torch.rand(n // k, k, generator=g).argsort(dim=1).reshape(n)
    return {name: v.to(torch.int32).cuda() for name, v in (
        ("beam", beams), ("permutation", perm), ("identity", torch.arange(n)),
        ("reverse", torch.arange(n).flip(0)))}


def gather_bytes(a: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes that a row gather of two arrays shaped like ``a`` must move at
    this ``idx``: each distinct source row read once, each destination row
    written once (a source row that several beams take is read from DRAM
    once; the copies after the first come from L2)."""
    row = a.shape[0] * a[0, 0].numel() * a.element_size()  # one axis-1 row, all layers
    return 2 * row * (int(idx.unique().numel()) + idx.numel())


# K3 at the bench's beam shape (Base, 128 utterances x beam 4, S = 60 + 1)
# in int8 (the bench's KV) and bf16, and a float32 case; K4 at its shape;
# and rows of 105 and 84 bytes, which take the kernel's narrow-word path.
GATHER_SHAPE = (8, 128 * BEAM_SIZE, 8, 52, 61)
GATHER_CASES = [("K3", GATHER_SHAPE, torch.int8), ("K3", GATHER_SHAPE, torch.bfloat16),
                ("K3", GATHER_SHAPE, torch.float32), ("K4", GATHER_SHAPE[:3] + (61,), torch.float32),
                ("K3", (2, 12, 3, 5, 7), torch.int8), ("K4", (2, 12, 3, 7), torch.float32)]


def phase_gather_vs_plain(bg) -> float:
    """K3 and K4 against their plain versions on the card, bit for bit
    (a gather is a copy); returns the largest error (0 when they agree)."""
    worst = 0.0
    for kid, shape, dtype in GATHER_CASES:
        fn = bg.gather_kv_rows if kid == "K3" else bg.gather_scale_rows
        a, b = gather_inputs(shape, dtype, seed=len(shape))
        for kind, idx in parent_vectors(shape[1], seed=3).items():
            out = fn(a, b, idx)
            torch.cuda.synchronize()
            ref = bg._gather_rows_torch(a, b, idx)
            ok = all(torch.equal(o, r) for o, r in zip(out, ref))
            err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
            worst = max(worst, err)
            log(f"  {kid} {tuple(shape)} {str(dtype)[6:]:8s} {kind:8s} "
                f"{'bit-exact' if ok else 'FAIL'} (max_abs_err {err:g})")
            if not ok:
                raise SystemExit(f"{kid} disagrees with its plain version at {shape} {dtype}")
    return worst


def phase_gather_times(bg) -> dict:
    """K3 (int8, bf16) and K4 at the bench's beam shape: kernel, plain
    version (index_select, which is also PyTorch's own call for a row
    gather) and the bound, on random beam parents (the decode's case; the
    bound counts only the distinct source rows they read) and on a
    permutation inside each utterance's beams (every row read once).  Before each timed call the card reads twice its
    L2's size (in the decode the step's other work evicts the caches' rows
    between reorders; a read leaves no dirty lines to write back) and then
    spins for about a millisecond, so that the host has enqueued the whole
    call before the start event fires: the timing is the device's alone,
    not the wrapper's Python time (which matters for K4's ~13 us)."""
    scratch = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device="cuda")

    def before():
        scratch.sum()
        torch.cuda._sleep(2_000_000)

    out = {}
    for label, fn, shape, dtype in (
            ("K3 int8", bg.gather_kv_rows, GATHER_SHAPE, torch.int8),
            ("K3 bf16", bg.gather_kv_rows, GATHER_SHAPE, torch.bfloat16),
            ("K4", bg.gather_scale_rows, GATHER_SHAPE[:3] + (61,), torch.float32)):
        a, b = gather_inputs(shape, dtype, seed=1)
        parents = parent_vectors(shape[1], seed=4)
        res = {"shape": list(shape), "dtype": str(dtype)[6:]}
        for kind, prefix in (("beam", ""), ("permutation", "perm_")):
            idx = parents[kind]
            kernel_ms = cuda_time_ms(lambda: fn(a, b, idx), before=before)
            plain_ms = cuda_time_ms(lambda: bg._gather_rows_torch(a, b, idx), before=before)
            bytes_moved = gather_bytes(a, idx)
            bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
            res.update({f"{prefix}kernel_ms": kernel_ms, f"{prefix}plain_ms": plain_ms,
                        f"{prefix}library_ms": plain_ms, f"{prefix}bytes": bytes_moved,
                        f"{prefix}bound_ms": bound_ms,
                        f"{prefix}distinct_rows": int(idx.unique().numel())})
            log(f"  {label} at {tuple(shape)}, {kind} parents "
                f"({res[f'{prefix}distinct_rows']} of {shape[1]} rows read): kernel "
                f"{kernel_ms:.4f} ms, index_select {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"(bytes: {bytes_moved / 1e6:.1f} MB) -> kernel at "
                f"{bytes_moved / kernel_ms / 1e9:.3f} TB/s, {bound_ms / kernel_ms:.1%} of bound")
        res["bound_by"] = "bytes"
        out[label] = res
    return out


def synthetic_clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
    tone = np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t))
    return (0.3 * tone + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def phase_main_path(ea, tokenizer_path: str, cfg) -> dict:
    """Transcriber(model="base") on the card, default options and with the
    VAD off (vad_threshold=0), on clips of 2-20 s."""
    from moonshine_tpu_torch import Transcriber

    clips = [synthetic_clip(s, i) for i, s in enumerate((2.5, 9.26, 17.0))]
    out = {"runs": []}
    for label, opts in (("default", {}), ("vad_threshold=0", {"vad_threshold": 0})):
        tr = Transcriber(model="base", tokenizer_path=tokenizer_path).with_options(**opts)
        tr.load()
        if not all(p.is_cuda for p in tr.model.parameters()):
            raise SystemExit("a model tensor is not on cuda")
        backend = tr._pipeline.backend
        encoded = []
        inner = backend.transcribe_segment

        def counting(audio, segment_id, is_final, inner=inner, encoded=encoded):
            if len(audio) >= cfg.min_samples():
                encoded.append(len(audio))
            return inner(audio, segment_id, is_final)

        backend.transcribe_segment = counting
        launches0 = ea.encoder_attention_packed.launches
        lines, walls = [], []
        for clip in clips:  # the text comes back to the host, so each wall is complete
            t0 = time.perf_counter()
            lines += [line.text or "" for line in tr.transcribe(clip).lines]
            walls.append(time.perf_counter() - t0)
        wall = sum(walls)
        tokens = sum(len(text.split()) for text in lines)  # one word per token here
        launched = ea.encoder_attention_packed.launches - launches0
        log(f"  {label}: {len(encoded)} segments encoded, {len(lines)} lines, ~{tokens} "
            f"tokens, {launched} K1 launches, {wall:.3f} s wall for "
            f"{sum(len(c) for c in clips) / SAMPLE_RATE:.2f} s of audio; per clip "
            + ", ".join(f"{len(c) / SAMPLE_RATE:g} s: {w:.3f} s" for c, w in zip(clips, walls)))
        for text in lines[:3]:
            log(f"    line: {text[:80]!r}")
        if launched < cfg.encoder_layers * len(encoded):
            raise SystemExit(f"K1 launched {launched} times for {len(encoded)} segments")
        out["runs"].append({"options": label, "segments": len(encoded), "lines": len(lines),
                            "k1_launches": launched, "wall_s": wall, "clip_wall_s": walls})
    if out["runs"][1]["segments"] < 1:
        raise SystemExit("the always-voice run transcribed no segment")
    out["model"] = tr.model
    return out


def phase_word_timestamps(model, tokenizer_path: str) -> dict:
    """Transcriber(model="base") with word_timestamps=True on the card (the
    main path's float32 model, VAD off), on the 9.26 s clip: every line
    gets words, each inside its line."""
    from moonshine_tpu_torch import Transcriber

    tr = Transcriber(model="base", tokenizer_path=tokenizer_path).with_params(model)
    tr.with_options(vad_threshold=0, word_timestamps=True).load()
    t0 = time.perf_counter()
    lines = tr.transcribe(synthetic_clip(BATCHED_SECONDS, 1)).lines
    wall = time.perf_counter() - t0
    words = [w for line in lines for w in line.words]
    inside = all(line.start_time - 1e-6 <= w.start <= w.end
                 <= line.start_time + line.duration + 1e-3
                 for line in lines for w in line.words)
    log(f"  {len(lines)} lines, {len(words)} words in {wall:.3f} s; first words "
        + ", ".join(f"{w.text} {w.start:.2f}-{w.end:.2f} s" for w in words[:4]))
    if not words or not inside:
        raise SystemExit("word timestamps missing or outside their line")
    return {"lines": len(lines), "words": len(words), "wall_s": wall}


def phase_reference_check(model, cfg) -> dict:
    """The card's encode (K1) and first decode step against the same model
    on the CPU (plain versions), float32, on a 3 s clip."""
    from moonshine_tpu_torch.models import moonshine as mm

    audio = torch.from_numpy(synthetic_clip(3.0, 7))[None]
    lengths = torch.tensor([audio.shape[1]])
    cpu_model = copy.deepcopy(model).to("cpu")
    res = {}
    with torch.inference_mode():
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            memory, mask = mm.encode(m, cfg, audio.to(dev), lengths.to(dev))
            kc, vc = mm.compute_cross_kv(m.decoder, cfg, memory)
            cache = mm.init_cache(cfg, 1, 4, kc, vc, mask)
            bos = torch.full((1, 1), cfg.decoder_start_token_id, device=dev)
            logits, _, _ = mm.decoder_apply(m.decoder, cfg, bos, cache)
            res[dev] = (memory.cpu(), logits.cpu())
    mem_err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    logit_err = float((res["cuda"][1] - res["cpu"][1]).abs().max())
    finite = bool(res["cuda"][0].isfinite().all() and res["cuda"][1].isfinite().all())
    log(f"  cuda vs cpu, Base float32, 3 s: memory {tuple(res['cuda'][0].shape)} max_abs_err "
        f"{mem_err:.3e}, first-step logits max_abs_err {logit_err:.3e} (tol 1e-3), "
        f"finite={finite}")
    if not finite or mem_err > 1e-3 or logit_err > 1e-3:
        raise SystemExit("the card's Base forward disagrees with the CPU's")
    return {"memory_max_abs_err": mem_err, "logits_max_abs_err": logit_err}


def _bench_inputs(cfg, batch: int):
    """The bench's inputs on the card: Base weights in bf16 from seed 0,
    ``batch`` clips of 9.26 s of Gaussian noise at 0.1 from seed 1, and caps
    forcing the full max_tokens.  Returns (model, audio, caps, max_tokens)."""
    from moonshine_tpu_torch.models import moonshine as mm

    n = int(SAMPLE_RATE * BATCHED_SECONDS)
    max_tokens = max(int(BATCHED_SECONDS * cfg.max_tokens_per_second), 8)
    model = mm.init_params(cfg, torch.Generator().manual_seed(0)).to("cuda", torch.bfloat16)
    audio = (torch.randn((batch, n), generator=torch.Generator().manual_seed(1)) * 0.1).cuda()
    caps = torch.full((batch,), max_tokens, device="cuda")
    return model, audio, caps, max_tokens


def batched_workload(cfg, batch: int):
    """The bench configuration on the card: the bench's inputs, int8 KV,
    greedy decode.  Returns (encode, decode, max_tokens), where encode()
    gives (memory, mask) and decode(memory, mask) the greedy result.
    scripts/torch_profile.py profiles this same workload."""
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.models import moonshine as mm

    model, audio, caps, max_tokens = _bench_inputs(cfg, batch)

    def encode():
        return mm.encode(model, cfg, audio)

    def decode(memory, mask):
        return greedy_decode(model, cfg, memory, mask, max_tokens=max_tokens,
                             token_caps=caps, kv_int8=True)

    return encode, decode, max_tokens


def beam_workload(cfg, batch: int):
    """The bench's offline-beam configuration on the card (bench.py's
    offline-beam phase): the bench's inputs, encode through K1
    (attn_impl="auto"), beam 4 with int8 KV, so K3 and K4 reorder the
    caches at every step.  Returns (encode, decode, max_tokens) as
    batched_workload does; scripts/torch_profile.py --decode beam profiles
    this same workload."""
    from moonshine_tpu_torch.decoding.beam import beam_decode
    from moonshine_tpu_torch.models import moonshine as mm

    model, audio, caps, max_tokens = _bench_inputs(cfg, batch)

    def encode():
        return mm.encode(model, cfg, audio, attn_impl="auto")

    def decode(memory, mask):
        return beam_decode(model, cfg, memory, mask, beam_size=BEAM_SIZE,
                           max_tokens=max_tokens, token_caps=caps, kv_int8=True)

    return encode, decode, max_tokens


def run_once(encode, decode):
    """One encode and one decode, each ended by a synchronise.  Returns
    (memory, result, encode s, decode s)."""
    with torch.inference_mode():
        t0 = time.perf_counter()
        memory, mask = encode()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = decode(memory, mask)
        torch.cuda.synchronize()
        return memory, res, t1 - t0, time.perf_counter() - t1


def check_decode(memory, res, cfg, batch: int, max_tokens: int, what: str) -> None:
    if not bool(memory.isfinite().all()) or tuple(res.tokens.shape) != (batch, max_tokens):
        raise SystemExit(f"{what} produced non-finite memory or a wrong shape")
    if int(res.tokens.min()) < 0 or int(res.tokens.max()) >= cfg.vocab_size:
        raise SystemExit(f"{what} produced token ids outside the vocabulary")


def phase_batched(ea, cfg, batch: int, card: str) -> dict:
    """encode + greedy_decode at the bench configuration (batched_workload)."""
    encode, decode, max_tokens = batched_workload(cfg, batch)
    memory, res, _, _ = run_once(encode, decode)  # warm-up
    check_decode(memory, res, cfg, batch, max_tokens, "batched decode")
    launches0 = ea.encoder_attention_packed.launches
    walls, encs, decs = [], [], []
    for _ in range(3):
        _, res, enc_s, dec_s = run_once(encode, decode)
        walls.append(enc_s + dec_s)
        encs.append(enc_s)
        decs.append(dec_s)
    per_encode = (ea.encoder_attention_packed.launches - launches0) / 3
    if per_encode != cfg.encoder_layers:
        raise SystemExit(f"K1 launched {per_encode} times per encode, not {cfg.encoder_layers}")
    best = min(walls)
    seconds = BATCHED_SECONDS
    out = {"batch": batch, "seconds": seconds, "max_tokens": max_tokens,
           "frames": int(memory.shape[1]), "wall_s": walls, "encode_s": encs,
           "decode_s": decs, "audio_s_per_s": batch * seconds / best,
           "mean_tokens": float(res.lengths.float().mean()),
           "k1_launches_per_encode": per_encode,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  B={batch} x {seconds} s (T={out['frames']}), {max_tokens} tokens, bf16, int8 KV: "
        f"best {best:.4f} s (encode {min(encs):.4f} s, decode {min(decs):.4f} s) -> "
        f"{out['audio_s_per_s']:.2f} audio-s/s on {card}; {per_encode:.0f} K1 launches per "
        f"encode; mean tokens {out['mean_tokens']:.1f}")
    return out


def phase_beam(ea, bg, cfg, batch: int, card: str) -> dict:
    """encode + beam_decode at the bench's offline-beam configuration
    (beam_workload): one warm-up and the best of 3.  K1 must launch once
    per encoder layer per encode, and K3 and K4 once per decode step (the
    steps the search reports it ran).  The returned launch counts cover the
    whole phase."""
    encode, decode, max_tokens = beam_workload(cfg, batch)
    counters = (ea.encoder_attention_packed, bg.gather_kv_rows, bg.gather_scale_rows)
    for c in counters:
        c.launches = 0
    memory, res, _, _ = run_once(encode, decode)  # warm-up
    check_decode(memory, res, cfg, batch, max_tokens, "batched beam")
    torch.cuda.reset_peak_memory_stats()
    before = [c.launches for c in counters]
    walls, encs, decs, all_steps = [], [], [], 0
    for _ in range(3):
        _, res, enc_s, dec_s = run_once(encode, decode)
        walls.append(enc_s + dec_s)
        encs.append(enc_s)
        decs.append(dec_s)
        all_steps += res.steps
    k1, k3, k4 = (c.launches - b for c, b in zip(counters, before))
    steps = all_steps / 3
    if k1 / 3 != cfg.encoder_layers:
        raise SystemExit(f"K1 launched {k1 / 3} times per encode, not {cfg.encoder_layers}")
    if not steps > 0 or k3 / 3 != steps or k4 / 3 != steps:
        raise SystemExit(f"K3/K4 launched {k3 / 3}/{k4 / 3} times per decode of {steps} steps")
    best = min(walls)
    out = {"batch": batch, "beam": BEAM_SIZE, "seconds": BATCHED_SECONDS,
           "max_tokens": max_tokens, "frames": int(memory.shape[1]), "wall_s": walls,
           "encode_s": encs, "decode_s": decs,
           "audio_s_per_s": batch * BATCHED_SECONDS / best,
           "encode_audio_s_per_s": batch * BATCHED_SECONDS / min(encs),
           "decode_audio_s_per_s": batch * BATCHED_SECONDS / min(decs),
           "steps_per_decode": steps, "mean_tokens": float(res.lengths.float().mean()),
           "k1_launches_per_encode": k1 / 3, "k3_launches_per_decode": k3 / 3,
           "k4_launches_per_decode": k4 / 3,
           "launches": {c.__name__: c.launches for c in counters},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  B={batch} x beam {BEAM_SIZE} x {BATCHED_SECONDS} s (T={out['frames']}), "
        f"{max_tokens} tokens, bf16, int8 KV: best {best:.4f} s (encode {min(encs):.4f} s, "
        f"decode {min(decs):.4f} s) -> {out['audio_s_per_s']:.2f} audio-s/s on {card}; "
        f"per encode {k1 / 3:.0f} K1 launches; per decode {steps:.0f} steps, "
        f"{k3 / 3:.0f} K3 and {k4 / 3:.0f} K4 launches; mean tokens {out['mean_tokens']:.1f}; "
        f"peak {out['peak_mem_gb']:.2f} GB")
    return out


def phase_beam_reference(model, cfg) -> dict:
    """Beam search on the card with the gather kernels ("auto") and with
    index_select ("xla"), float and int8 KV, Base float32: bit-identical
    results, since the gather is an exact copy.  Then the float-KV run
    against the same model's plain run on the CPU: scores within 1e-3, and
    tokens equal unless the CPU's best two beams lie within 1e-3 (a near-tie
    that float32 summation order may break either way)."""
    from moonshine_tpu_torch.decoding import beam
    from moonshine_tpu_torch.models import moonshine as mm

    clips = [synthetic_clip(s, 20 + i) for i, s in enumerate((4.0, 2.5))]
    audio = torch.zeros(2, len(clips[0]))
    for i, c in enumerate(clips):
        audio[i, :len(c)] = torch.from_numpy(c)
    lengths = torch.tensor([len(c) for c in clips])
    kw = dict(beam_size=BEAM_SIZE, max_tokens=12)
    out = {}
    with torch.inference_mode():
        memory, mask = mm.encode(model, cfg, audio.cuda(), lengths.cuda())
        for kv_int8 in (False, True):
            runs = [beam.beam_decode(model, cfg, memory, mask, kv_int8=kv_int8,
                                     gather_impl=impl, **kw) for impl in ("auto", "xla")]
            same = (runs[0].steps == runs[1].steps
                    and all(torch.equal(a, b) for a, b in zip(runs[0][:3], runs[1][:3])))
            log(f"  kv_int8={kv_int8}: gather_impl auto vs xla "
                f"{'bit-identical' if same else 'DIFFER'}; tokens {runs[0].lengths.tolist()} "
                f"long, scores {[round(x, 5) for x in runs[0].scores.tolist()]}")
            if not same:
                raise SystemExit("beam search differs between gather_impl auto and xla")
            out[f"kv_int8={kv_int8}"] = {"lengths": runs[0].lengths.tolist(),
                                         "scores": runs[0].scores.tolist()}
            if not kv_int8:
                cuda_res = runs[0]
        cpu_model = copy.deepcopy(model).to("cpu")
        memory_c, mask_c = mm.encode(cpu_model, cfg, audio, lengths)
        cpu_res = beam.beam_decode(cpu_model, cfg, memory_c, mask_c, **kw)
        all_beams = beam._search(cpu_model, cfg, memory_c, mask_c, **kw)
    top2 = all_beams.scores.sort(dim=1, descending=True).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    score_err = float((cuda_res.scores.cpu() - cpu_res.scores).abs().max())
    same_tokens = [torch.equal(a.cpu(), b) for a, b in zip(cuda_res.tokens, cpu_res.tokens)]
    log(f"  cuda vs cpu, float KV: scores max_abs_err {score_err:.3e} (tol 1e-3); tokens "
        f"equal per clip {same_tokens}; CPU top-2 beam score margin "
        f"{[f'{m:.3e}' for m in margin]}")
    if score_err > 1e-3 or any(not eq and m >= 1e-3 for eq, m in zip(same_tokens, margin)):
        raise SystemExit("the card's beam search disagrees with the CPU's")
    out.update(score_max_abs_err=score_err, tokens_equal=same_tokens, cpu_top2_margin=margin)
    return out


def phase_eval(bg, cfg, tok_path: str, root: str, card: str) -> dict:
    """The LibriSpeech harness (eval/librispeech.py) with beam 4 on Base
    bf16 over 16 synthetic wav + txt clips of 3-14 s.  The weights are
    random, so the WER is printed, not checked.  The harness keeps float
    KV caches, as the JAX one does, so K3 reorders them and K4 has no
    scales to move."""
    from moonshine_tpu_torch.audio.wav import save_wav
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.eval.librispeech import evaluate
    from moonshine_tpu_torch.models import moonshine as mm

    for i, seconds in enumerate(np.linspace(3.0, 14.0, 16)):
        save_wav(os.path.join(root, f"clip{i:02d}.wav"), synthetic_clip(seconds, 40 + i),
                 SAMPLE_RATE)
        with open(os.path.join(root, f"clip{i:02d}.txt"), "w") as f:
            f.write(f"W{3 + i} W{40 + i} SOME WORDS\n")
    model = mm.init_params(cfg, torch.Generator().manual_seed(0)).to("cuda", torch.bfloat16)
    for c in (bg.gather_kv_rows, bg.gather_scale_rows):
        c.launches = 0
    res = evaluate(model, cfg, BinTokenizer.from_file(tok_path), root, batch_size=16,
                   beam_size=BEAM_SIZE)
    res["launches"] = {c.__name__: c.launches for c in (bg.gather_kv_rows, bg.gather_scale_rows)}
    log(f"  {res['utterances']} clips, {res['audio_seconds']:.2f} s of audio, beam "
        f"{res['beam_size']}: WER {res['wer']:.4f} ({res['errors']} errors / {res['words']} "
        f"words, random weights), {res['audio_seconds_per_second']:.2f} audio-s/s on {card}; "
        f"launches {res['launches']}")
    if res["utterances"] != 16 or res["launches"]["gather_kv_rows"] < 1:
        raise SystemExit("the eval harness did not decode every clip through K3")
    return res


def gather_entry(name: str, replaces: str, launches: int, max_err: float, t: dict,
                 extra: dict | None = None) -> dict:
    return {"name": name, "route": "cuda", "source": "moonshine_tpu_torch/csrc/beam_gather.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": max_err, "tol": "exact",
            "dtype": t["dtype"], "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "perm_ms": t["perm_kernel_ms"],
            "perm_bound_ms": t["perm_bound_ms"], **(extra or {})}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64,
                        help="batch of the batched offline decode (the bench uses 512)")
    parser.add_argument("--beam-batch", type=int, default=128,
                        help="utterances of the batched beam decode (the bench's 128)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    from moonshine_tpu_torch.core.config import BASE
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.ops import _build
    from moonshine_tpu_torch.ops import beam_gather as bg
    from moonshine_tpu_torch.ops import encoder_attention as ea

    t_start = time.perf_counter()
    card = card_line()
    log(f"[setup] {sys.version.split()[0]} torch {torch.__version__} CUDA {torch.version.cuda}")
    log(f"[setup] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] TF32 off for products and convolutions: "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.build()
    log(f"[setup] kernels {list(_build.KERNELS)} built in {time.perf_counter() - t0:.2f} s")

    log("[kernel vs plain] K1")
    max_err = phase_kernel_vs_plain(ea)
    log("[kernel vs plain] K3, K4")
    gather_err = phase_gather_vs_plain(bg)
    log("[kernel times] K1")
    times = phase_kernel_times(ea)
    log("[kernel times] K3, K4")
    gather_times = phase_gather_times(bg)

    with tempfile.TemporaryDirectory() as tmp:
        tok_path = os.path.join(tmp, "tokenizer.bin")
        vocab = [b"<unk>", b"<s>", b"</s>"] + [f"▁w{i}".encode() for i in
                                               range(3, BASE.vocab_size)]
        with open(tok_path, "wb") as f:
            f.write(BinTokenizer(vocab).to_bytes())
        log("[main path] Transcriber(model='base') on cuda")
        ea.encoder_attention_packed.launches = 0
        main_path = phase_main_path(ea, tok_path, BASE)
        main_launches = ea.encoder_attention_packed.launches
        model = main_path.pop("model")
        log("[reference check]")
        ref = phase_reference_check(model, BASE)
        log("[word timestamps]")
        words = phase_word_timestamps(model, tok_path)
        log("[beam reference check]")
        beam_ref = phase_beam_reference(model, BASE)
        del model
        log("[batched offline decode]")
        batched = phase_batched(ea, BASE, args.batch, card)
        log("[batched beam]")
        beam = phase_beam(ea, bg, BASE, args.beam_batch, card)
        log("[eval harness]")
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        evaluation = phase_eval(bg, BASE, tok_path, corpus, card)

    k3, k4 = gather_times["K3 int8"], gather_times["K4"]
    k3_bf16 = gather_times["K3 bf16"]
    kernels = [{
        "name": "encoder_attention_packed", "route": "cuda",
        "source": "moonshine_tpu_torch/csrc/encoder_attention.cu",
        "replaces": "moonshine_tpu/ops/encoder_attention.py:111",
        "launches": main_launches, "max_abs_err": max_err,
        "tol": {k: list(TOL[getattr(torch, k)]) for k in ("float32", "bfloat16")},
        "ms": times["kernel_ms"], "kernel_ms": times["kernel_ms"],
        "plain_ms": times["plain_ms"], "library_ms": times["library_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
    }, gather_entry("gather_kv_rows", "moonshine_tpu/ops/beam_gather.py:30",
                    beam["launches"]["gather_kv_rows"], gather_err, k3,
                    {"bf16_ms": k3_bf16["kernel_ms"], "bf16_plain_ms": k3_bf16["plain_ms"],
                     "bf16_bound_ms": k3_bf16["bound_ms"]}),
        gather_entry("gather_scale_rows", "moonshine_tpu/ops/beam_gather.py:76",
                     beam["launches"]["gather_scale_rows"], gather_err, k4)]
    record = {"card": card, "torch": torch.__version__, "kernels": kernels,
              "kernel_times": times, "gather_times": gather_times, "main_path": main_path,
              "reference_check": ref, "word_timestamps": words,
              "beam_reference_check": beam_ref, "batched": batched,
              "beam": beam, "eval": evaluation, "total_s": time.perf_counter() - t_start}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[done] {record['total_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
