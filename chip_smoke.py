#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moonshine_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 64] [--beam-batch 128]

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch
version on the card (K1 and K2 also: a batch row alone gives the bits it
gets in a batch, and every bf16 and float32 build of them holds tensor-core
and cp.async instructions, read with cuobjdump), times it beside its bound
and PyTorch's own call for the same function, drives the offline
transcription path through ``Transcriber(model="base")`` with random
weights (and once with word timestamps), checks the card's forward, beam
search and speculative decoding against the CPU's, and runs the bench's
batched offline decodes of Moonshine Base (bf16, int8 KV, 9.26 s clips):
greedy, and beam 4 over 128 clips. Then the parallel layer's path on a
world-1 NCCL group and its 1x1 mesh (sharded encoder attention, greedy,
beam and speculative decoding of the mesh's rows; every rank's share of a
4x2 mesh against the unsharded kernels), and the bench's speculative
configuration (Tiny draft, Base verifier), and the LibriSpeech eval harness
with beam 4 on a synthetic corpus. Then w8a8, checkpoints and the streaming
family: ``[w8a8 main path]`` (the main path's Base through
``quant.quantize_tree_exec``, driven by
``Transcriber(model="base").with_params(...)`` on the card, its float32
tokens held against the CPU's), ``[checkpoint and catalog]`` (the same Base
written as an HF checkpoint with a tokenizer into a temporary
``MOONSHINE_TPU_CACHE/base-en/``; ``Transcriber("base", "en")`` must
resolve both and transcribe as ``with_params`` does, ``transcribe_wav`` as
``transcribe`` of the wav's samples), ``[w8a8 batched]`` (the bench's
``--w8a8`` mode beside the float run), ``[streaming]``
(``Transcriber(model="medium_streaming")`` through a stream, 10 s in 0.5 s
chunks: update latencies and audio-s/s) and ``[streaming reference]``
(medium_streaming's tokens on the card against the CPU's). Then the
multi-stream service: ``[serving]`` (the bench's headline configuration:
64 medium_streaming streams in 2 cohorts through
``ShardedStreamingService``, bf16, int8 KV, 0.64 s updates, 15 s segments;
20 of the bench's 40 update periods: throughput, update and final
latencies, memory), ``[serving reference]`` (a float32 service's events
and states on the card against the CPU's), ``[serving vad]`` (TinyVad on
an in-memory graph of TinyVadCNN's contract, card against CPU, inside a
service) and ``[streaming bench]`` (``eval/streaming_bench.run_bench``);
none of them runs a kernel of the repository. Then speaker identification
and spelling: ``[speakers and spelling]`` (``Transcriber(model="base")
.with_options(identify_speakers=True)`` over a 60 s synthetic two-speaker
conversation in 0.5 s chunks; the diarizer's activities, embeddings and
turns held against a CPU diarizer with the same weights and audio; K1 runs
in every encode) and ``[spelling]`` (the spelling CNN and ``SpellingOnnx``
on an in-memory graph of SpellingCNN's contract, card against CPU, and a
spelling-mode stream through the pipeline ``Transcriber`` with
``spelling_params``). Then the voice agent: ``[embeddings]``
(EmbeddingGemma-300m at full width from a seed, card against CPU on
phrases and a document in the 512 bucket; ``embed_tokens``' device time),
``[agent]`` (a scripted conversation through ``AgentFlow`` over the card's
and the CPU's embedder, and over a cached-embeddings TSV) and ``[tts and
voice loop]`` (``TextToSpeech(language="en")`` at ``TTSConfig()``, card
against CPU; then its speech through ``Transcriber(model="base")``, K1 in
every encode, and the transcripts into an ``AgentFlow`` that speaks through
``tts.say``). Then the code-only and published-pack voices and voice
cloning: ``[klatt]`` (``TextToSpeech().voice("klatt")`` and ``KlattTTS``,
card against CPU), ``[neural pack decoder and worldlite]`` (``TfliteExecutor``
over an in-memory graph of the voice pack decoder's contract, all tiles in
one batch, then ``worldlite.render`` of 3 s with injected noise, card
against CPU; ``NeuralPackTTS`` itself waits for the pack), ``[voice
clone]`` (a ``VoiceClone`` capture of the TTS's speech, its word times
from ``Transcriber(model="base")``, K1 in every encode, then
``VoiceCloner()`` with the iSTFT head and an ``OnnxVocoder``, card against
CPU on the same latent) and ``[tok_pos]`` (``TokPosTagger``, card against
CPU). Every phase that
fails ends the run with a non-zero exit. The last two lines of standard
output are the kernels' JSON summary and the device JSON; a fuller record
goes to chiprun_out/chip_smoke.json. Without CUDA, or without the rest of
the repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Data-sheet peaks of one H100 SXM (used for the bound, not measured).
# float32: a float32-exact product on the bf16 tensor cores, each operand
# split into three bf16 parts and six of the nine partial products taken.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 989e12 / 6}
# K1 and K2 against their plain versions, (atol, rtol).  Each kernel rounds
# at its plain version's points (K1 the weights and the output to the I/O
# dtype, K2 the output only).  bf16: the two differ only in float32
# summation order, so outputs may differ by about one rounding step: rtol
# 8e-3 covers one bf16 step (at most 2^-7 relative) at any magnitude, and
# atol 4e-3 (twice the largest difference seen on an H100, 1.95e-3) covers
# outputs near zero, where rtol allows nothing.  float32: the kernels round
# nothing that the plain versions do not (K1's rounding of the weights is
# the identity), and both products run as six bf16 passes on the tensor
# cores, whose float32 accumulation is not IEEE round-to-nearest (P.V sums
# each 64-key tile on them and adds the tiles in IEEE float32).  Largest
# differences seen on an H100 over every float32 case of both phases (the
# Transcriber's six buckets included): K1 2.5e-6, 0.43 of this limit; K2
# 2.4e-6, 0.36.  The kernels' arithmetic with the two lo passes left out
# already falls outside it (tests/test_torch_encoder_attention.py).
TOL = {torch.float32: (2e-6, 1e-5), torch.bfloat16: (4e-3, 8e-3)}
# The w8a8 model, card against CPU, both float32: largest difference of the
# teacher-forced logits.  Dynamic int8 activations turn float32 rounding
# differences into whole int8 steps wherever a value sits near a rounding
# boundary, so the two devices' w8a8 logits differ by far more than their
# float32 ones (PERF.md §6: 2.8e-2 on an H100 at 700 W, where the float32
# model's first-step logits differ by 1.1e-6).  A token may then differ
# where the CPU's two best logits are closer than twice this.
W8A8_LOGIT_TOL = 0.1
# [serving reference]: the float32 service's final memory and cross keys,
# card against CPU, after five updates of a 10-layer window encoder (the
# single-stream model's memory differs by 7.4e-5 after 800 frames in
# [streaming reference] on an H100).
SERVING_REF_TOL = 1e-3
# [serving vad]: TinyVad's probabilities and mel rings, card against CPU
# (float32 log-mel and a small CNN; the standardisation divides by the
# window's std, at least 1e-3).
VAD_PROB_TOL = 1e-5
SPEC_BATCH = 32  # the bench's speculative phase: Base verifier, Tiny draft, 32 clips
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


def bucket_frames(cfg) -> list[int]:
    """T of one segment padded to each of the Transcriber's duration
    buckets, 2, 4, ..., 64 s (82, 165, 332, 665, 1,332 and 2,665 for Base)."""
    return [cfg.frames_for_samples(SAMPLE_RATE * 2**i) for i in range(1, 7)]


def phase_kernel_vs_plain(ea, cfg) -> float:
    """K1 against its plain version on the card; returns the largest error."""
    worst = 0.0
    # Base at the bench's T (and T=415), Tiny's hd=36 at T=384 and 97, and
    # the shapes the Transcriber gives it: one segment padded to each of its
    # buckets, and T=83 and 666 beside the 2 and 16 s ones, where K1's kt
    # rows (4T bytes in float32, 2T in bf16) take other copy widths.
    cases = [(16, 384, 8, 52, m) for m in (False, True)] + [
        (4, 415, 8, 52, True), (4, 384, 8, 36, True), (4, 97, 8, 36, True)] + [
        (1, t, cfg.encoder_heads, cfg.head_dim, True) for t in bucket_frames(cfg) + [83, 666]]
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
            used = float((err / (atol + rtol * ref.float().abs())).max())
            log(f"  K1 B={b} T={t} H={h} hd={hd} {str(dtype)[6:]:8s} "
                f"{'masked' if masked else 'unmasked':8s} max_abs_err={float(err.max()):.3e} "
                f"tol=atol {atol:g} + rtol {rtol:g} (largest err/tol {used:.3f}) "
                f"{'ok' if ok else 'FAIL'}")
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
    res = {"shape": [b, t, h, hd], "dtype": "bfloat16", "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **attention_bound(b, t, h, hd, dtype, f32_weights=False)}
    log(f"  K1 at B={b} T={t} H={h} hd={hd} bf16: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {res['bytes'] / 1e6:.1f} MB, {res['flops'] / 1e9:.1f} GFLOP)")
    return res


def attention_bound(b, t, h, hd, dtype, f32_weights: bool) -> dict:
    """The least time of one encoder attention call: q, k, v read and out
    written once, against its two products of 2*B*H*T^2*hd operations each.
    Q.K^T takes I/O-dtype operands; P.V takes the weights, which K1 rounds to
    the I/O dtype and K2 keeps in float32.  A float32-exact product runs on
    the bf16 tensor cores with each float32 operand split into three bf16
    parts: float32 weights with bf16 values as three passes (K2's bf16 P.V,
    at a third of the bf16 rate), two float32 operands as six passes (both
    products of float32 I/O, PEAK_FLOPS[float32])."""
    bytes_moved = 4 * b * t * h * hd * torch.empty((), dtype=dtype).element_size()
    half = 2 * b * h * t * t * hd
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    if f32_weights and dtype == torch.bfloat16:
        pv_rate = PEAK_FLOPS[torch.bfloat16] / 3
    else:
        pv_rate = PEAK_FLOPS[dtype]
    t_flops = (half / PEAK_FLOPS[dtype] + half / pv_rate) * 1e3
    return {"bytes": bytes_moved, "flops": 2 * half, "bytes_ms": t_bytes,
            "operations_ms": t_flops, "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def hm_inputs(b, t, h, hd, dtype, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, t, h, hd), generator=g).to("cuda", dtype) for _ in range(3))
    mask = None
    if lengths is not None:
        mask = (torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]).cuda()
    return q, k, v, mask


def phase_hm_vs_plain(ea) -> float:
    """K2 against its plain version on the card; returns the largest error.
    Base at the bench's T (ragged lengths, the last row with no valid key;
    and unmasked), T=415, Tiny's hd=36 and one rank's share of a 4x2 mesh
    (B/4 rows, H/2 heads); then the 64 s bucket at B=1 (T=2,665, a segment
    shorter than its bucket) and Tiny's hd=36 at T=97."""
    worst = 0.0
    cases = [(16, 384, 8, 52, m) for m in (False, True)] + [
        (4, 415, 8, 52, True), (4, 384, 8, 36, True), (4, 384, 4, 52, True),
        (1, 2665, 8, 52, True), (4, 97, 8, 36, True)]
    for b, t, h, hd, masked in cases:
        if not masked:
            lengths = None
        elif b == 1:
            lengths = [t * 3 // 4]
        else:
            lengths = [max(t - i * (t // b), 1) for i in range(b - 1)] + [0]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = hm_inputs(b, t, h, hd, dtype, lengths, seed=b + t + hd + 1)
            out = ea.encoder_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = ea._encoder_attention_torch(q, k, v, mask)
            err = (out.float() - ref.float()).abs()
            atol, rtol = TOL[dtype]
            ok = bool((err <= atol + rtol * ref.float().abs()).all()) and bool(out.isfinite().all())
            worst = max(worst, float(err.max()))
            used = float((err / (atol + rtol * ref.float().abs())).max())
            log(f"  K2 B={b} T={t} H={h} hd={hd} {str(dtype)[6:]:8s} "
                f"{'masked' if masked else 'unmasked':8s} max_abs_err={float(err.max()):.3e} "
                f"tol=atol {atol:g} + rtol {rtol:g} (largest err/tol {used:.3f}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 disagrees with its plain version at B={b} T={t} hd={hd}")
    return worst


def phase_hm_times(ea) -> dict:
    """K2, its plain version and SDPA (head-major views, additive float key
    mask) in bf16 at the bench shape (Base, B=512, T=384) and at one rank's
    share of it on a 4x2 mesh ([128, 384, 4, 52])."""
    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (b, t, h, hd) in (("base", (512, 384, 8, 52)), ("shard_4x2", (128, 384, 4, 52))):
        dtype = torch.bfloat16
        q, k, v, _ = hm_inputs(b, t, h, hd, dtype, None, seed=2)
        kernel_ms = cuda_time_ms(lambda: ea.encoder_attention(q, k, v, None))
        plain_ms = cuda_time_ms(lambda: ea._encoder_attention_torch(q, k, v, None))
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, hd] views
        add_mask = torch.zeros((b, 1, 1, t), device="cuda", dtype=dtype)
        library_ms = cuda_time_ms(lambda: sdpa(qs, ks, vs, attn_mask=add_mask))
        res = {"shape": [b, t, h, hd], "dtype": "bfloat16", "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **attention_bound(b, t, h, hd, dtype, f32_weights=True)}
        log(f"  K2 at [{b}, {t}, {h}, {hd}] bf16: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}; bytes {res['bytes'] / 1e6:.1f} MB = {res['bytes_ms']:.4f} ms, "
            f"{res['flops'] / 1e9:.1f} GFLOP with P.V as three bf16 passes = "
            f"{res['operations_ms']:.4f} ms)")
        out[label] = res
    return out


def phase_batch_independence(ea) -> dict:
    """K1 and K2 on a B=16 batch (Base heads, T=384, ragged lengths down to
    a row with no valid key), each row against the same row run alone, bit
    for bit: a row's result may not depend on B or on where its blocks fall
    in the grid (the sharded path's bit-identity checks rest on this)."""
    b, t, h, hd = 16, 384, 8, 52
    lengths = [max(t - 23 * i, 0) for i in range(b)]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, kt, v, mask = attention_inputs(b, t, h, hd, dtype, lengths, seed=16)
        k = kt.view(b, h, hd, t).permute(0, 3, 1, 2).contiguous()  # [B, T, H, hd]
        qh, vh = q.view(b, t, h, hd), v.view(b, t, h, hd)
        runs = {"K1": (lambda *x: ea.encoder_attention_packed(*x, h), (q, kt, v)),
                "K2": (ea.encoder_attention, (qh, k, vh))}
        for name, (fn, args) in runs.items():
            whole = fn(*args, mask)
            same = all(torch.equal(whole[i:i + 1], fn(*(x[i:i + 1].contiguous() for x in args),
                                                      mask[i:i + 1].contiguous()))
                       for i in range(b))
            key = f"{name} {str(dtype)[6:]}"
            out[key] = same
            log(f"  {key} B={b} T={t}: every row alone == its row of the batch: "
                f"{'bit-identical' if same else 'DIFFER'}")
            if not same:
                raise SystemExit(f"{name} gives a row other bits in a batch than alone")
    return out


# The float32 shapes the Transcriber's float32 model gives K1, one segment
# (a quarter of it padding) at its 2 s, 16 s and 64 s buckets (T =
# frames_for_samples(BASE, 2, 16, 64 s)), and K2 at the 16 s one.
F32_CASES = [("K1", (1, 82, 8, 52)), ("K1", (1, 665, 8, 52)), ("K1", (1, 2665, 8, 52)),
             ("K2", (1, 665, 8, 52))]


def phase_f32_times(ea) -> dict:
    """K1 and K2 in float32 at F32_CASES: kernel, plain version, float32
    SDPA (additive -1e9 key mask) and the bound with both products at the
    float32-exact tensor-core rate (six bf16 passes).  These calls take tens
    of microseconds, so before each timed one the card spins for about a
    millisecond: the host has enqueued the whole call before the start event
    fires, and the timing is the device's alone.  The timed kernel's output
    is held against the plain version's on the same inputs, within TOL."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = torch.float32
    spin = lambda: torch.cuda._sleep(2_000_000)
    out = {}
    for name, (b, t, h, hd) in F32_CASES:
        if name == "K1":
            q, k, v, mask = attention_inputs(b, t, h, hd, dtype, [t * 3 // 4], seed=3)
            kernel = lambda: ea.encoder_attention_packed(q, k, v, mask, h)
            plain = lambda: ea._encoder_attention_packed_torch(q, k, v, mask, h)
            qs, ks, vs = (q.view(b, t, h, hd).transpose(1, 2), k.view(b, h, hd, t).transpose(2, 3),
                          v.view(b, t, h, hd).transpose(1, 2))
        else:
            q, k, v, mask = hm_inputs(b, t, h, hd, dtype, [t * 3 // 4], seed=3)
            kernel = lambda: ea.encoder_attention(q, k, v, mask)
            plain = lambda: ea._encoder_attention_torch(q, k, v, mask)
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        add_mask = torch.zeros((b, 1, 1, t), device="cuda", dtype=dtype).masked_fill(
            ~mask[:, None, None, :], -1e9)
        library = lambda: sdpa(qs, ks, vs, attn_mask=add_mask)
        res = {"kernel": name, "shape": [b, t, h, hd], "dtype": "float32",
               **{f"{key}_ms": cuda_time_ms(fn, runs=21, before=spin) for key, fn in
                  (("kernel", kernel), ("plain", plain), ("library", library))},
               **attention_bound(b, t, h, hd, dtype, f32_weights=name == "K2")}
        got, ref = kernel(), plain()
        atol, rtol = TOL[dtype]
        err = (got - ref).abs()
        res["max_abs_err"] = float(err.max())
        ok = bool((err <= atol + rtol * ref.abs()).all()) and bool(got.isfinite().all())
        log(f"  {name} at [{b}, {t}, {h}, {hd}] float32: kernel {res['kernel_ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, SDPA {res['library_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {res['flops'] / 1e9:.3f} GFLOP at "
            f"{PEAK_FLOPS[dtype] / 1e12:.1f} TFLOP/s = {res['operations_ms']:.4f} ms; bytes "
            f"{res['bytes'] / 1e6:.2f} MB = {res['bytes_ms']:.4f} ms); max_abs_err against "
            f"plain {res['max_abs_err']:.3e} (largest err/tol "
            f"{float((err / (atol + rtol * ref.abs())).max()):.3f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} float32 disagrees with its plain version at T={t}")
        out[f"{name} {t}"] = res
    return out


def phase_sass(_build) -> dict:
    """The SASS of the built encoder-attention library (cuobjdump -sass):
    per kernel the count of tensor-core instructions (HMMA, HGMMA) and of
    asynchronous global-to-shared copies (LDGSTS, cp.async).  Fails unless
    every bf16 (encoder_attention_mma_kernel) and every float32
    (encoder_attention_f32_kernel) instantiation has both."""
    lib = _build.build(("encoder_attention",))["encoder_attention"]
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0, "LDGSTS": 0}
        elif name is not None:
            for op in counts[name]:
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
    out = {}
    for fn, c in sorted(counts.items()):
        m = re.search(r"(mma|f32)_kernelILb([01])ELi(\d)E", fn)
        if m is None:
            continue
        label = (f"{'K2' if m[2] == '1' else 'K1'} {'bf16' if m[1] == 'mma' else 'float32'}, "
                 f"head_dim {16 * int(m[3]) - 15}-{16 * int(m[3])}")
        out[label] = c
        log(f"  {label}: {c['HMMA']} HMMA, {c['HGMMA']} HGMMA, {c['LDGSTS']} LDGSTS")
    for route in ("bf16", "float32"):
        kernels = [c for k, c in out.items() if f" {route}," in k]
        if len(kernels) != 16 or any(c["HMMA"] + c["HGMMA"] == 0 or c["LDGSTS"] == 0
                                     for c in kernels):
            raise SystemExit(f"a {route} attention kernel is missing or lacks tensor-core or "
                             "cp.async instructions")
    return out


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


def batched_workload(cfg, batch: int, w8a8: bool = False):
    """The bench configuration on the card: the bench's inputs, int8 KV,
    greedy decode; with ``w8a8`` the bench's --w8a8 mode, the weights
    exec-quantized after the rotary preparation (bench.py:111-121), so
    every dense layer runs as int8 x int8 -> int32.  Returns (encode,
    decode, max_tokens), where encode() gives (memory, mask) and
    decode(memory, mask) the greedy result.  scripts/torch_profile.py
    profiles this same workload."""
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.quant import quantize_tree_exec

    model, audio, caps, max_tokens = _bench_inputs(cfg, batch)
    if w8a8:
        model = quantize_tree_exec(model)

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


def phase_batched(ea, cfg, batch: int, card: str, w8a8: bool = False) -> dict:
    """encode + greedy_decode at the bench configuration (batched_workload,
    with w8a8 weights if asked): one warm-up and the best of 3."""
    encode, decode, max_tokens = batched_workload(cfg, batch, w8a8)
    launches_start = ea.encoder_attention_packed.launches
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
           "k1_launches": ea.encoder_attention_packed.launches - launches_start, "w8a8": w8a8,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  B={batch} x {seconds} s (T={out['frames']}), {max_tokens} tokens, bf16, int8 KV"
        f"{', w8a8 weights' if w8a8 else ''}: "
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


def phase_sharded(ea, bg, cfg, draft_cfg, batch: int, card: str) -> dict:
    """The parallel layer's inference path on a world-1 NCCL group and its
    1x1 mesh (the card is one GPU), Base bf16 at ``batch`` clips of 9.26 s:
    the encode with the sharded packed attention (K1), the sharded
    head-major attention (K2) on the first encoder layer's own q, k and v,
    and greedy (int8 KV), beam 4 (int8 KV) and speculative decoding (Tiny
    draft encoded on the mesh too, gamma 4, float KV) of the mesh's rows,
    gathered back.  The counts of K1-K4 are set to 0 before that and read
    after it: K1 launches once per encoder layer of both models, K2 once,
    K3 and K4 once per beam step.  Then the checks: the sharded encode equals
    ``attn_impl="auto"`` bit for bit; the sharded K2 equals the unsharded
    K2 bit for bit and its plain version within ``TOL``; every rank's body of a 4x2 mesh, run here one after another and
    assembled, equals the unsharded K1 and K2 bit for bit (each (row,
    head)'s arithmetic is unchanged); the gathered greedy tokens equal an
    unsharded greedy decode's.  The group is destroyed at the end."""
    import torch.distributed as dist

    from moonshine_tpu_torch.decoding.beam import beam_decode
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.decoding.speculative import speculative_decode_batched
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.ops.rotary import rotary_tables
    from moonshine_tpu_torch.parallel.distributed import host_local_batch_to_global, initialize
    from moonshine_tpu_torch.parallel.mesh import make_mesh
    from moonshine_tpu_torch.parallel.sharding import shard_batch

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # a group of one host
    t0 = time.perf_counter()
    initialize()
    mesh = make_mesh(data=1, model=1)
    log(f"  {dist.get_backend()} group of {dist.get_world_size()}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}, up in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        model, audio, caps, max_tokens = _bench_inputs(cfg, batch)
        draft = draft_model(draft_cfg, torch.bfloat16)
        counters = (ea.encoder_attention_packed, ea.encoder_attention, bg.gather_kv_rows,
                    bg.gather_scale_rows)
        for c in counters:
            c.launches = 0
        with torch.inference_mode():
            t0 = time.perf_counter()
            rows, row_caps = shard_batch(mesh, (audio, caps))
            memory, mask = mm.encode(model, cfg, rows, attn_impl="pallas_shmap", mesh=mesh)
            feats, _ = mm.frontend_apply(model.frontend, cfg, rows)
            cos, sin = rotary_tables(torch.arange(feats.shape[1], device="cuda"), cfg.rotary_dim,
                                     cfg.rope_theta)
            q, k, v = (x.view(*x.shape[:2], cfg.encoder_heads, cfg.head_dim) for x in
                       mm._encoder_qkv(cfg, feats, model.encoder.layers[0], cos, sin))
            attn = ea.encoder_attention_sharded(q, k, v, None, mesh)
            greedy = greedy_decode(model, cfg, memory, mask, max_tokens=max_tokens,
                                   token_caps=row_caps, kv_int8=True)
            beam = beam_decode(model, cfg, memory, mask, beam_size=BEAM_SIZE,
                               max_tokens=max_tokens, token_caps=row_caps, kv_int8=True)
            d_mem, d_mask = mm.encode(draft, draft_cfg, rows, attn_impl="pallas_shmap", mesh=mesh)
            spec = speculative_decode_batched(draft, draft_cfg, model, cfg, d_mem, d_mask, memory,
                                              mask, gamma=4, max_tokens=max_tokens,
                                              token_caps=row_caps)
            full_memory, greedy_g, beam_g, spec_g = host_local_batch_to_global(
                mesh, (memory, greedy, beam, spec))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}

            ref_memory, _ = mm.encode(model, cfg, audio, attn_impl="auto")
            kt = k.flatten(2).transpose(1, 2).contiguous()
            k1_ref = ea.encoder_attention_packed(q.flatten(2), kt, v.flatten(2), None,
                                                 cfg.encoder_heads)
            k2_ref = ea.encoder_attention(q, k, v, None)
            k2_plain = ea._encoder_attention_torch(q, k, v, None)
            k1_bodies, k2_bodies = torch.empty_like(k1_ref), torch.empty_like(k2_ref)
            shape = (4, 2)
            rb, hb = batch // shape[0], cfg.encoder_heads // shape[1]
            for d in range(shape[0]):
                for m in range(shape[1]):
                    rows_d = slice(d * rb, (d + 1) * rb)
                    k2_bodies[rows_d, :, m * hb:(m + 1) * hb] = ea.encoder_attention_sharded_body(
                        q, k, v, None, (d, m), shape)
                    lanes = slice(m * hb * cfg.head_dim, (m + 1) * hb * cfg.head_dim)
                    k1_bodies[rows_d, :, lanes] = ea.encoder_attention_packed_sharded_body(
                        q.flatten(2), kt, v.flatten(2), None, cfg.encoder_heads, (d, m), shape)
            greedy_ref = greedy_decode(model, cfg, ref_memory, mask, max_tokens=max_tokens,
                                       token_caps=caps, kv_int8=True)
        checks = {
            "encode pallas_shmap == auto": torch.equal(full_memory, ref_memory),
            "K2 sharded == unsharded": torch.equal(attn, k2_ref),
            "K1 4x2 bodies == unsharded": torch.equal(k1_bodies, k1_ref),
            "K2 4x2 bodies == unsharded": torch.equal(k2_bodies, k2_ref),
            "greedy on the mesh == unsharded": torch.equal(greedy_g.tokens, greedy_ref.tokens),
        }
        for name, ok in checks.items():
            log(f"  {name}: {'bit-identical' if ok else 'DIFFER'}")
        if not checks["encode pallas_shmap == auto"]:
            diff = (full_memory.float() - ref_memory.float()).abs()
            log(f"    memory: {int((diff > 0).sum())} of {diff.numel()} values differ, by at most "
                f"{float(diff.max()):.3e}, in rows {sorted(set((diff > 0).nonzero()[:, 0].tolist()))[:16]}")
        atol, rtol = TOL[attn.dtype]
        k2_err = (attn.float() - k2_plain.float()).abs()
        checks["K2 sharded ~ plain"] = bool(
            (k2_err <= atol + rtol * k2_plain.float().abs()).all()) and bool(attn.isfinite().all())
        log(f"  K2 sharded vs plain on layer 0's q, k, v {tuple(q.shape)} "
            f"{str(attn.dtype)[6:]}: max_abs_err {float(k2_err.max()):.3e} tol=atol {atol:g} "
            f"+ rtol {rtol:g} {'ok' if checks['K2 sharded ~ plain'] else 'FAIL'}")
        for what, res in (("greedy", greedy_g), ("beam", beam_g), ("speculative", spec_g)):
            check_decode(full_memory, res, cfg, batch, max_tokens, f"{what} on the mesh")
        log(f"  B={batch} on the mesh: encode, K2 and greedy / beam {BEAM_SIZE} / speculative "
            f"(gamma 4) decodes in {wall:.3f} s on {card}; speculative rounds {spec.rounds}, "
            f"accepted draft tokens {int(spec.accepted_draft_tokens.sum())}; launches {launches}")
        if not all(checks.values()):
            raise SystemExit("the sharded path differs from the unsharded one")
        want = {"encoder_attention_packed": cfg.encoder_layers + draft_cfg.encoder_layers,
                "encoder_attention": 1, "gather_kv_rows": beam.steps,
                "gather_scale_rows": beam.steps}
        if launches != want or not beam.steps:
            raise SystemExit(f"the sharded path launched {launches}, not {want}")
        return {"backend": dist.get_backend(), "world": dist.get_world_size(),
                "mesh": list(mesh.shape), "batch": batch, "wall_s": wall, "launches": launches,
                "checks": checks, "spec_rounds": spec.rounds,
                "spec_accepted": int(spec.accepted_draft_tokens.sum())}
    finally:
        dist.destroy_process_group()


def draft_model(dcfg, dtype):
    """The speculative draft on the card: random weights from seed 1, an
    unrelated model to the verifier's seed 0."""
    from moonshine_tpu_torch.models import moonshine as mm

    return mm.init_params(dcfg, torch.Generator().manual_seed(1)).to("cuda", dtype)


def speculative_workload(vcfg, dcfg, batch: int):
    """The JAX bench's speculative configuration (bench.py spec_bench) on
    the card: the bench's inputs (_bench_inputs: Base verifier in bf16,
    ``batch`` clips of 9.26 s, 60 tokens), a Tiny draft in bf16, gamma 4,
    float KV.  Returns (encode, decode, max_tokens): encode() gives (draft
    memory, mask, verifier memory, mask); decode(*memories, kind=) the floor
    (the unrelated random draft; the default), the ceiling (the verifier as
    its own draft) or the verifier's greedy decode.
    scripts/torch_profile.py --decode speculative traces the floor."""
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.decoding.speculative import speculative_decode_batched
    from moonshine_tpu_torch.models import moonshine as mm

    verify, audio, caps, max_tokens = _bench_inputs(vcfg, batch)
    draft = draft_model(dcfg, torch.bfloat16)

    def encode():
        return (*mm.encode(draft, dcfg, audio), *mm.encode(verify, vcfg, audio))

    def decode(d_mem, d_mask, v_mem, v_mask, kind: str = "floor"):
        if kind == "greedy":
            return greedy_decode(verify, vcfg, v_mem, v_mask, max_tokens=max_tokens,
                                 token_caps=caps)
        pair = (draft, dcfg, d_mem, d_mask) if kind == "floor" else (verify, vcfg, v_mem, v_mask)
        return speculative_decode_batched(pair[0], pair[1], verify, vcfg, pair[2], pair[3],
                                          v_mem, v_mask, gamma=4, max_tokens=max_tokens,
                                          token_caps=caps)

    return encode, decode, max_tokens


def phase_speculative(vcfg, dcfg, batch: int, card: str) -> dict:
    """speculative_workload: three decodes of the same memories, the
    floor, the ceiling and the verifier's greedy decode; each one warm-up
    and the best of 2.  audio-s/s counts the decode only, as the bench
    does."""
    encode, decode, max_tokens = speculative_workload(vcfg, dcfg, batch)
    with torch.inference_mode():
        memories = encode()
    v_mem = memories[2]
    runs = {kind: (lambda kind=kind: decode(*memories, kind=kind))
            for kind in ("floor", "ceiling", "greedy")}
    out = {"batch": batch, "max_tokens": max_tokens, "gamma": 4}
    results = {}
    for name, fn in runs.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        results[name] = res
        best = min(walls[1:])
        row = {"wall_s": walls[1:], "audio_s_per_s": batch * BATCHED_SECONDS / best,
               "mean_tokens": float(res.lengths.float().mean())}
        if name != "greedy":
            row.update(rounds=res.rounds, accepted=int(res.accepted_draft_tokens.sum()),
                       emitted=int(res.lengths.sum()))
        out[name] = row
        check_decode(v_mem, res, vcfg, batch, max_tokens, f"speculative {name}")
        log(f"  {name:8s} B={batch} x {BATCHED_SECONDS} s, {max_tokens} tokens, bf16, float KV: "
            f"best {best:.4f} s -> {row['audio_s_per_s']:.2f} audio-s/s on {card}"
            + (f"; {row['rounds']} rounds, {row['accepted']} accepted draft tokens of "
               f"{int(res.lengths.sum())} emitted" if name != "greedy" else
               f"; mean tokens {row['mean_tokens']:.1f}"))
    match = float((results["ceiling"].tokens == results["greedy"].tokens).float().mean())
    out["ceiling_greedy_token_match"] = match
    log(f"  ceiling vs greedy token match {match:.4f} (bf16: the verify pass over 5 tokens and "
        "the greedy step over 1 may round apart; the float32 reference phase holds them equal)")
    return out


def _verifier_margin(model, cfg, memory, mask, tokens, step: int, kv_int8: bool) -> float:
    """The gap between the verifier's two best logits at ``step``, teacher-
    forced on ``tokens`` (one lane, on the model's device)."""
    from moonshine_tpu_torch.decoding import speculative as sp
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.ops.int8_kv import quantize_kv

    dev = memory.device
    seq = torch.cat([torch.tensor([cfg.decoder_start_token_id], device=dev), tokens[:step]])
    kc, vc = mm.compute_cross_kv(model.decoder, cfg, memory)
    ks = vs = None
    if kv_int8:
        kc, ks = quantize_kv(kc)
        vc, vs = quantize_kv(vc)
    shape = (cfg.decoder_layers, 1, cfg.decoder_kv_heads, cfg.head_dim, seq.numel())
    k_self, v_self = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
    with torch.inference_mode():
        cursor = torch.zeros(1, dtype=torch.long, device=dev)
        logits = sp._decoder_apply_vec(model.decoder, cfg, seq[None], cursor, k_self, v_self,
                                       kc, vc, mask, ks, vs)
    top = logits[0, -1].topk(2).values
    return float(top[0] - top[1])


def phase_speculative_reference(verify, vcfg, dcfg) -> dict:
    """Speculative decoding on the card against the CPU's, Base verifier
    (the main path's float32 model) and Tiny draft in float32, 2 clips of 4
    and 2.5 s, 12 tokens, gamma 1 and 4, float and int8 cross KV: the
    tokens equal the CPU's, and with float KV also the verifier's greedy
    decode on the card.  Where card and CPU differ, the CPU verifier's
    top-2 logit margin at the first differing step is printed."""
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.decoding.speculative import speculative_decode_batched
    from moonshine_tpu_torch.models import moonshine as mm

    draft = draft_model(dcfg, torch.float32)
    clips = [synthetic_clip(s, 30 + i) for i, s in enumerate((4.0, 2.5))]
    audio = torch.zeros(2, len(clips[0]))
    for i, c in enumerate(clips):
        audio[i, :len(c)] = torch.from_numpy(c)
    lengths = torch.tensor([len(c) for c in clips])
    models = {"cuda": (verify, draft),
              "cpu": (copy.deepcopy(verify).to("cpu"), copy.deepcopy(draft).to("cpu"))}
    mems = {}
    with torch.inference_mode():
        for dev, (vm, dm) in models.items():
            mems[dev] = (*mm.encode(dm, dcfg, audio.to(dev), lengths.to(dev)),
                         *mm.encode(vm, vcfg, audio.to(dev), lengths.to(dev)))
        greedy = greedy_decode(verify, vcfg, *mems["cuda"][2:], max_tokens=12)
    out, failed = {}, False
    for gamma in (1, 4):
        for kv_int8 in (False, True):
            res = {dev: speculative_decode_batched(
                dm, dcfg, vm, vcfg, *mems[dev], gamma=gamma, max_tokens=12, kv_int8=kv_int8)
                for dev, (vm, dm) in models.items()}
            same_cpu = (torch.equal(res["cuda"].tokens.cpu(), res["cpu"].tokens)
                        and torch.equal(res["cuda"].lengths.cpu(), res["cpu"].lengths))
            same_greedy = torch.equal(res["cuda"].tokens, greedy.tokens)
            key = f"gamma={gamma} kv_int8={kv_int8}"
            out[key] = {"equal_cpu": same_cpu, "equal_greedy": same_greedy,
                        "lengths": res["cuda"].lengths.tolist(), "rounds": res["cuda"].rounds}
            log(f"  {key}: card == cpu {same_cpu}; card == card greedy {same_greedy}; lengths "
                f"{res['cuda'].lengths.tolist()}, {res['cuda'].rounds} rounds, accepted "
                f"{res['cuda'].accepted_draft_tokens.tolist()}")
            if not same_cpu:
                diff = (res["cuda"].tokens.cpu() != res["cpu"].tokens)
                lane, step = (int(x) for x in diff.nonzero()[0])
                margin = _verifier_margin(models["cpu"][0], vcfg, mems["cpu"][2][lane:lane + 1],
                                          mems["cpu"][3][lane:lane + 1], res["cpu"].tokens[lane],
                                          step, kv_int8)
                out[key]["cpu_top2_margin"] = margin
                log(f"    first difference: clip {lane}, step {step}; CPU verifier top-2 logit "
                    f"margin there {margin:.3e}")
                failed = True
            if not kv_int8 and not same_greedy:
                failed = True
    if failed:
        raise SystemExit("speculative decoding on the card disagrees with the CPU or with greedy")
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


def _clip_tokens(model, cfg, clip: np.ndarray, dev: str, max_tokens: int = 48):
    """One clip's encode (K1 on the card, its plain version on the CPU) and
    greedy decode, float32 caches.  Returns (memory, mask, tokens [T],
    length)."""
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.models import moonshine as mm

    audio = torch.from_numpy(clip)[None].to(dev)
    with torch.inference_mode():
        memory, mask = mm.encode(model, cfg, audio, torch.tensor([len(clip)], device=dev))
        res = greedy_decode(model, cfg, memory, mask, max_tokens=max_tokens)
    return memory, mask, res.tokens[0].cpu(), int(res.lengths[0])


def _forced_logits(model, cfg, memory, mask, tokens) -> torch.Tensor:
    """Float32 logits [len(tokens) + 1, V] of a decode teacher-forced on
    ``tokens`` after BOS, on the model's device, brought to the CPU."""
    from moonshine_tpu_torch.models import moonshine as mm

    seq = torch.cat([torch.tensor([cfg.decoder_start_token_id]), tokens]).to(memory.device)
    with torch.inference_mode():
        kc, vc = mm.compute_cross_kv(model.decoder, cfg, memory)
        cache = mm.init_cache(cfg, 1, seq.numel(), kc, vc, mask)
        logits, _, _ = mm.decoder_apply(model.decoder, cfg, seq[None], cache)
    return logits[0].cpu()


def phase_w8a8_main_path(ea, tokenizer_path: str, model, cfg) -> dict:
    """The main path with w8a8 weights: the main path's float32 Base model
    through quant.quantize_tree_exec (int8 dense layers run as int8 x int8
    products by torch._int_mm, the B=1 decode's single row padded to 17),
    driven by Transcriber(model="base", device=None).with_params(...) on
    the card, VAD off, on clips of 2.5 and 9.26 s.  K1 must launch in every
    encoder layer.  Then the reference: one 4 s clip's float32 greedy
    tokens on the card against the same quantized model on the CPU, and
    both devices' logits teacher-forced on the CPU's tokens.  The logits
    must agree within W8A8_LOGIT_TOL, and the tokens must be equal up to a
    first difference (printed) where the CPU's top-2 margin is within twice
    that, a near-tie that the int8 rounding can flip."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.quant import quantize_tree_exec

    qmodel = quantize_tree_exec(model)
    if not all(qmodel.encoder.layers[i].mlp.fc1.quantized for i in range(cfg.encoder_layers)):
        raise SystemExit("quantize_tree_exec left a dense layer float")
    tr = Transcriber(model="base", tokenizer_path=tokenizer_path, device=None)
    tr.with_params(qmodel).with_options(vad_threshold=0).load()
    if tr.device.type != "cuda" or tr.model.decoder.layers[0].mlp.fc1.w_q.device.type != "cuda":
        raise SystemExit("the w8a8 Transcriber is not on cuda")
    clips = [synthetic_clip(s, 20 + i) for i, s in enumerate((2.5, BATCHED_SECONDS))]
    ea.encoder_attention_packed.launches = 0
    lines, walls = [], []
    for clip in clips:
        t0 = time.perf_counter()
        lines += [line.text or "" for line in tr.transcribe(clip).lines]
        walls.append(time.perf_counter() - t0)
    launched = ea.encoder_attention_packed.launches
    log(f"  {len(lines)} lines, {launched} K1 launches, {sum(walls):.3f} s wall for "
        f"{sum(len(c) for c in clips) / SAMPLE_RATE:.2f} s of audio; per clip "
        + ", ".join(f"{len(c) / SAMPLE_RATE:g} s: {w:.3f} s" for c, w in zip(clips, walls)))
    if launched < cfg.encoder_layers * len(clips):
        raise SystemExit(f"K1 launched {launched} times for {len(clips)} w8a8 segments")

    clip = synthetic_clip(4.0, 9)
    cpu_model = copy.deepcopy(qmodel).to("cpu")
    got = {dev: _clip_tokens(m, cfg, clip, dev) for dev, m in (("cuda", qmodel),
                                                                ("cpu", cpu_model))}
    (mem_g, mask_g, t_gpu, n_gpu), (mem_c, mask_c, t_cpu, n_cpu) = got["cuda"], got["cpu"]
    # Both devices teacher-forced on the CPU's tokens: the logits' largest
    # difference, and the CPU's top-2 margin at every step.
    forced = {"cuda": _forced_logits(qmodel, cfg, mem_g, mask_g, t_cpu[:n_cpu]),
              "cpu": _forced_logits(cpu_model, cfg, mem_c, mask_c, t_cpu[:n_cpu])}
    logit_err = float((forced["cuda"] - forced["cpu"]).abs().max())
    top = forced["cpu"].topk(2, dim=-1).values
    margins = top[:, 0] - top[:, 1]
    diff = (t_gpu != t_cpu).nonzero()  # EOS-padded: a length change differs too
    first = int(diff[0]) if len(diff) else None
    margin = float(margins[first]) if first is not None else None
    ok = logit_err <= W8A8_LOGIT_TOL and (first is None or margin <= 2 * W8A8_LOGIT_TOL)
    out = {"lines": len(lines), "k1_launches": launched, "wall_s": walls,
           "reference": {"tokens": n_cpu, "equal_cpu": first is None,
                         "forced_logits_max_abs_err": logit_err, "tol": W8A8_LOGIT_TOL,
                         "first_difference": first, "cpu_top2_margin": margin}}
    log(f"  reference, 4 s, float32 w8a8: teacher-forced logits card vs cpu max_abs_err "
        f"{logit_err:.3e} (tol {W8A8_LOGIT_TOL}); card tokens == cpu tokens {first is None} "
        f"({n_gpu} and {n_cpu} tokens)"
        + (f"; first difference at step {first}, where the CPU's top-2 logit margin is "
           f"{margin:.3e}" if first is not None else ""))
    if not ok:
        raise SystemExit("the w8a8 model on the card disagrees with the CPU beyond the int8 "
                         "rounding's reach")
    return out


def phase_checkpoint(ea, tokenizer_path: str, model, cfg, root: str) -> dict:
    """Checkpoint import and catalog resolution on the card: the main
    path's float32 Base written as an HF Moonshine checkpoint
    (weights.export_hf_moonshine, weights.save_safetensors) with the
    tokenizer into a temporary MOONSHINE_TPU_CACHE/base-en/; then
    Transcriber("base", "en").load() resolves both through the catalog and
    must give the transcript that with_params of the same model gives, and
    transcribe_wav of a written wav the transcript of its samples."""
    import shutil

    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.audio.wav import load_wav, save_wav
    from moonshine_tpu_torch.weights import export_hf_moonshine, save_safetensors

    entry = os.path.join(root, "base-en")
    os.makedirs(entry)
    t0 = time.perf_counter()
    save_safetensors(os.path.join(entry, "model.safetensors"), export_hf_moonshine(model))
    shutil.copy(tokenizer_path, os.path.join(entry, "tokenizer.bin"))
    write_s = time.perf_counter() - t0
    old = os.environ.get("MOONSHINE_TPU_CACHE")
    os.environ["MOONSHINE_TPU_CACHE"] = root
    try:
        t0 = time.perf_counter()
        tr = Transcriber("base", "en").with_options(vad_threshold=0).load()
        load_s = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["MOONSHINE_TPU_CACHE"]
        else:
            os.environ["MOONSHINE_TPU_CACHE"] = old
    if str(tr._weights) != os.path.join(entry, "model.safetensors") or tr.device.type != "cuda":
        raise SystemExit(f"the catalog resolved {tr._weights} on {tr.device}")
    ref = Transcriber("base", tokenizer_path=tokenizer_path).with_params(model)
    ref.with_options(vad_threshold=0).load()
    wav = os.path.join(root, "clip.wav")
    save_wav(wav, synthetic_clip(BATCHED_SECONDS, 11), SAMPLE_RATE)
    samples, _ = load_wav(wav)
    ea.encoder_attention_packed.launches = 0
    texts = {"catalog": [line.text for line in tr.transcribe(samples).lines],
             "wav": [line.text for line in tr.transcribe_wav(wav).lines]}
    launched = ea.encoder_attention_packed.launches
    texts["with_params"] = [line.text for line in ref.transcribe(samples).lines]
    same = texts["catalog"] == texts["with_params"] == texts["wav"]
    log(f"  checkpoint {os.path.getsize(os.path.join(entry, 'model.safetensors')) / 1e6:.1f} MB "
        f"written in {write_s:.2f} s, Transcriber('base', 'en') loaded through the catalog in "
        f"{load_s:.2f} s; transcripts equal (catalog, transcribe_wav, with_params) {same}; "
        f"{launched} K1 launches; first line {texts['catalog'][0][:60]!r}")
    if not same or launched < 2 * cfg.encoder_layers:
        raise SystemExit("the catalog's checkpoint does not transcribe as the model it came from")
    return {"load_s": load_s, "write_s": write_s, "k1_launches": launched,
            "lines": len(texts["catalog"])}


def phase_streaming(tokenizer_path: str, card: str) -> dict:
    """Transcriber(model="medium_streaming") on the card (random weights,
    VAD off) through create_stream, over a 10 s synthetic clip fed in
    0.5 s chunks with an update interval of 0.5 s.  Each add_audio that
    updates ends with the host reading the decoded tokens, so its wall
    time is complete: the update latencies (p50, p90) and audio-s/s."""
    from moonshine_tpu_torch import Transcriber

    seconds, chunk_s = 10.0, 0.5
    tr = Transcriber(model="medium_streaming", tokenizer_path=tokenizer_path)
    tr.with_options(vad_threshold=0).load()
    if tr.device.type != "cuda":
        raise SystemExit("the streaming Transcriber is not on cuda")
    clip = synthetic_clip(seconds, 12)
    n = int(chunk_s * SAMPLE_RATE)
    out = {}
    for run in ("warm-up", "timed"):
        stream = tr.create_stream(update_interval=chunk_s)
        events = []
        stream.add_listener(lambda e: events.append(type(e).__name__))
        stream.start()
        lat = []
        t_start = time.perf_counter()
        for i in range(0, len(clip), n):
            before = stream._last_update_time
            t0 = time.perf_counter()
            stream.add_audio(clip[i:i + n])
            if stream._last_update_time != before:
                lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        final = stream.stop()
        stop_ms = (time.perf_counter() - t0) * 1e3
        wall = time.perf_counter() - t_start
        tr.free_stream(stream)
        out[run] = {"updates": len(lat), "latency_ms": lat, "stop_ms": stop_ms, "wall_s": wall,
                    "audio_s_per_s": seconds / wall, "events": len(events),
                    "p50_ms": float(np.percentile(lat, 50)) if lat else None,
                    "p90_ms": float(np.percentile(lat, 90)) if lat else None}
    row = out["timed"]
    text = " ".join(line.text or "" for line in final.lines)
    log(f"  medium_streaming, {seconds:g} s in {chunk_s:g} s chunks: {row['updates']} updates, "
        f"update latency p50 {row['p50_ms']:.1f} ms, p90 {row['p90_ms']:.1f} ms, final pass "
        f"{row['stop_ms']:.1f} ms; {row['audio_s_per_s']:.2f} audio-s/s on {card}; "
        f"{len(final.lines)} lines, {len(text.split())} words, {row['events']} events")
    if not final.lines or not all(line.is_complete for line in final.lines) or not row["updates"]:
        raise SystemExit("the stream produced no complete line or no update")
    out["lines"] = len(final.lines)
    return out


def _stream_tokens(model, cfg, clip: np.ndarray, dev: str, max_tokens: int = 26):
    """A whole clip through the streaming model on ``dev``: frontend,
    final encode, greedy decode.  Returns (state, tokens)."""
    from moonshine_tpu_torch.models import streaming as ms

    n = len(clip) // cfg.frame_len * cfg.frame_len
    state = ms.init_state(cfg, device=dev)
    state = ms.frontend_step(model, cfg, torch.from_numpy(clip[:n]).to(dev), state)
    state, _ = ms.encode(model, cfg, state, is_final=True)
    tokens, state = ms.decode_full(model, cfg, state, max_tokens=max_tokens)
    return state, tokens


def phase_streaming_reference(cfg) -> dict:
    """medium_streaming's widths, float32, random weights from seed 0: a
    4 s clip's final tokens on the card against the CPU's (the same
    parameters).  Where they differ, the first differing step and the CPU's
    top-2 logit margin there are printed and the phase fails."""
    from moonshine_tpu_torch.models import streaming as ms

    model = ms.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    cpu_model = copy.deepcopy(model).to("cpu")
    clip = synthetic_clip(4.0, 13)
    (s_gpu, t_gpu), (s_cpu, t_cpu) = (_stream_tokens(m, cfg, clip, d) for m, d in
                                      ((model, "cuda"), (cpu_model, "cpu")))
    mem_err = float((s_gpu.memory[:s_cpu.mem_len].cpu() - s_cpu.memory[:s_cpu.mem_len]).abs().max())
    same = t_gpu == t_cpu
    log(f"  medium_streaming, 4 s, float32: {s_cpu.mem_len} memory frames, memory max_abs_err "
        f"{mem_err:.3e}; card tokens == cpu tokens {same} ({len(t_gpu)} and {len(t_cpu)} tokens)")
    out = {"tokens": len(t_cpu), "equal_cpu": same, "memory_max_abs_err": mem_err}
    if not same:
        step = next((i for i, (a, b) in enumerate(zip(t_gpu, t_cpu)) if a != b),
                    min(len(t_gpu), len(t_cpu)))
        seq = torch.tensor([cfg.bos_id] + t_cpu[:step])
        logits, _, _ = ms.decode_tokens(cpu_model, cfg, seq, ms.decoder_reset(s_cpu))
        top = logits[-1].topk(2).values
        out.update(first_difference=step, cpu_top2_margin=float(top[0] - top[1]))
        log(f"    first difference at step {step}; CPU top-2 logit margin there "
            f"{out['cpu_top2_margin']:.3e}")
        raise SystemExit("the streaming model's tokens on the card differ from the CPU's")
    return out


# The bench's streaming service (bench.py's _ServiceHarness and its
# defaults): medium_streaming, 64 streams in 2 cohorts, bf16 compute, int8
# KV, 128 frames (0.64 s) fed per update, 15 s segments, mem_bucket 3,200,
# draft_cap 128.  SERVING_UPDATES cuts the bench's 40 update periods to 20.
SERVING_KW = dict(update_frames=128, mem_bucket=3200, draft_cap=128, max_segment_seconds=15.0)
SERVING_STREAMS, SERVING_COHORTS, SERVING_UPDATES = 64, 2, 20


def serving_audio(n_streams: int, seconds: float = 44.0, seed: int = 14):
    """The bench's service audio with Gaussian noise at 0.1 in place of its
    44 s recording: the base clip tiled four times; slot i starts reading
    at i/S of the base clip.  Returns (tiled audio, offsets)."""
    base = (np.random.default_rng(seed).standard_normal(int(seconds * SAMPLE_RATE))
            * 0.1).astype(np.float32)
    return np.concatenate([base] * 4), [int(i * len(base) / n_streams) for i in range(n_streams)]


def serving_workload(n_streams: int, n_cohorts: int):
    """[serving]'s service: medium_streaming, random weights from seed 0,
    at the bench's sizes, warmed up, then the bench's stagger: slot i is
    pre-filled with i/S of a 15 s segment, so that force-splits spread over
    the updates.  The bench drains that backlog with decoding updates; this
    drains it with ingest-only ones (the same encodes, no decode), which
    takes seconds instead of minutes.  Returns (service, feed(slot, n),
    warm-up seconds)."""
    from moonshine_tpu_torch.core.config import STREAMING_ARCHS
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.serving import ShardedStreamingService, StreamingService

    cfg = STREAMING_ARCHS["medium_streaming"]
    model = ms.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    kw = dict(SERVING_KW, compute_dtype=torch.bfloat16, kv_int8=True)
    if n_cohorts > 1:
        svc = ShardedStreamingService(model, cfg, None, n_streams=n_streams, n_cohorts=n_cohorts,
                                      **kw)
    else:
        svc = StreamingService(model, cfg, None, n_streams, **kw)
    del model
    warmup_s = svc.warmup()
    tiled, cursors = serving_audio(n_streams)

    def feed(slot: int, n: int) -> None:
        svc.add_audio(slot, tiled[cursors[slot]:cursors[slot] + n])
        cursors[slot] += n

    step = SERVING_KW["update_frames"] * 80
    period = int(SERVING_KW["max_segment_seconds"] * SAMPLE_RATE)
    cohorts = svc.cohorts if n_cohorts > 1 else [svc]
    for i in range(n_streams):
        feed(i, (i * period // n_streams) // step * step)
    for _ in range(int(SERVING_KW["max_segment_seconds"] / 0.64) + 4):
        for c in cohorts:
            c.update(decode_tick=False)
    return svc, feed, warmup_s


def state_bytes(state) -> dict:
    """Bytes of a BatchedStreamingState by group (what its shapes hold)."""
    groups = {"cross K/V": ("k_cross", "v_cross"), "cross scales": ("k_cross_scale", "v_cross_scale"),
              "self K/V": ("k_self", "v_self"), "self scales": ("k_self_scale", "v_self_scale"),
              "feats": ("feats",), "memory": ("memory",)}
    out = {g: sum(getattr(state, f).numel() * getattr(state, f).element_size() for f in fields
                  if getattr(state, f) is not None) for g, fields in groups.items()}
    out["total"] = sum(x.numel() * x.element_size() for x in state if x is not None)
    return out


def kernel_launches(ea, bg) -> dict:
    return {c.__name__: c.launches for c in (ea.encoder_attention_packed, ea.encoder_attention,
                                             bg.gather_kv_rows, bg.gather_scale_rows)}


def reset_launches(ea, bg) -> None:
    for c in (ea.encoder_attention_packed, ea.encoder_attention, bg.gather_kv_rows,
              bg.gather_scale_rows):
        c.launches = 0


def phase_serving(card: str) -> dict:
    """The bench's headline configuration on the card: 64 medium_streaming
    streams in 2 cohorts through ShardedStreamingService, bf16, int8 KV,
    SERVING_UPDATES update periods of 0.64 s, each cohort ticked in turn
    after its slots are fed (bench.py's timed loop)."""
    from moonshine_tpu_torch.core.config import STREAMING_ARCHS
    from moonshine_tpu_torch.models import streaming_batch as sb

    S, K = SERVING_STREAMS, SERVING_COHORTS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    svc, feed, warmup_s = serving_workload(S, K)
    setup_s = time.perf_counter() - t_setup
    step = SERVING_KW["update_frames"] * 80
    per = S // K
    update_ms, final_ms, events_n = [], [], 0
    t0 = time.perf_counter()
    for _ in range(SERVING_UPDATES):
        for c in range(K):
            for i in range(c * per, (c + 1) * per):
                feed(i, step)
            t1 = time.perf_counter()
            events = svc.update(cohort=c)
            update_ms.append((time.perf_counter() - t1) * 1e3)
            events_n += len(events)
            final_ms += [e.latency_ms for e in events if e.is_final]
    wall = time.perf_counter() - t0
    audio_s = S * SERVING_UPDATES * step / SAMPLE_RATE
    peak = torch.cuda.max_memory_allocated()
    # The state's bytes as its shapes give them, against the allocator's
    # count for one more cohort's state allocated alone.
    reckoned = state_bytes(svc.cohorts[0].state)
    before = torch.cuda.memory_allocated()
    extra = sb.init_batch_state(STREAMING_ARCHS["medium_streaming"], per, dtype=torch.bfloat16,
                                mem_cap=SERVING_KW["mem_bucket"], kv_int8=True, device="cuda")
    allocated = torch.cuda.memory_allocated() - before
    del extra
    out = {"streams": S, "cohorts": K, "updates": SERVING_UPDATES, "bench_updates": 40,
           "setup_s": setup_s, "warmup_s": warmup_s, "wall_s": wall, "audio_s": audio_s,
           "audio_s_per_s": audio_s / wall, "update_ms": update_ms,
           "update_ms_p50": float(np.percentile(update_ms, 50)),
           "update_ms_p95": float(np.percentile(update_ms, 95)),
           "final_ms_p50": float(np.percentile(final_ms, 50)) if final_ms else None,
           "n_finals": len(final_ms), "events": events_n, "peak_bytes": peak,
           "state_bytes_per_cohort": reckoned, "state_bytes_allocated": allocated}
    log(f"  cut: {SERVING_UPDATES} update periods (the bench runs 40); the stagger's pre-fill "
        "drained with ingest-only updates (the bench decodes them)")
    final_p50 = "none" if not final_ms else f"{out['final_ms_p50']:.1f} ms"
    log(f"  medium_streaming, {S} streams in {K} cohorts, bf16, int8 KV, 0.64 s updates: warm-up "
        f"{warmup_s:.2f} s (set-up {setup_s:.2f} s); {out['audio_s_per_s']:.2f} audio-s/s; "
        f"update wall p50 {out['update_ms_p50']:.1f} ms, p95 {out['update_ms_p95']:.1f} ms; "
        f"final-update latency p50 {final_p50}; {len(final_ms)} finals, {events_n} events; "
        f"peak allocated {peak / 1e9:.3f} GB on {card}")
    log("  state per cohort of " + f"{per} streams: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in reckoned.items())
        + f"; the allocator took {allocated / 1e6:.1f} MB for one more, on {card}")
    if not update_ms or not events_n or abs(allocated - reckoned["total"]) > 0.01 * allocated:
        raise SystemExit("the service produced no event, or its state is not the size reckoned")
    del svc
    torch.cuda.empty_cache()
    return out


def _service_log(events) -> list:
    return [(e.slot, e.segment_id, e.text, e.is_final, round(e.start_time, 6),
             round(e.end_time, 6)) for e in events]


def phase_serving_reference(cfg, card: str) -> dict:
    """Four medium_streaming streams in one float32 StreamingService on the
    card and on the CPU (the same weights, from seed 0, and audio), five
    update periods, the last closing every slot: the events, and so the
    tokens (no tokenizer: a text is its token list), must be equal, and
    the final memory and cross keys within SERVING_REF_TOL."""
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.serving import StreamingService

    S = 4
    model = ms.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    cpu_model = copy.deepcopy(model).to("cpu")
    tiled, offsets = serving_audio(S)
    step = SERVING_KW["update_frames"] * 80
    runs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        svc = StreamingService(m, cfg, None, S, device=dev, **SERVING_KW)
        t0 = time.perf_counter()
        log_ = []
        for u in range(5):
            for i in range(S):
                if u == 0:
                    svc.open_slot(i)
                svc.add_audio(i, tiled[offsets[i] + u * step:offsets[i] + (u + 1) * step])
                if u == 4:
                    svc.close_slot(i)
            log_.append(_service_log(svc.update()))
        runs[dev] = (log_, svc.state, time.perf_counter() - t0)
    (g_log, g_state, g_s), (c_log, c_state, c_s) = runs["cuda"], runs["cpu"]
    errs = {f: float((getattr(g_state, f).cpu() - getattr(c_state, f)).abs().max())
            for f in ("memory", "k_cross")}
    finals = sum(e[3] for u in c_log for e in u)
    same = g_log == c_log
    log(f"  medium_streaming, {S} streams, float32, 5 updates of 0.64 s (card {g_s:.2f} s, cpu "
        f"{c_s:.2f} s): events equal {same} ({sum(map(len, c_log))} events, {finals} finals); "
        f"memory max_abs_err {errs['memory']:.3e}, k_cross {errs['k_cross']:.3e} "
        f"(tolerance {SERVING_REF_TOL:g}) on {card}")
    out = {"events_equal": same, "events": sum(map(len, c_log)), "finals": finals,
           "max_abs_err": errs, "card_s": g_s, "cpu_s": c_s}
    if not same:
        for u, (a, b) in enumerate(zip(g_log, c_log)):
            if a != b:
                log(f"    first difference at update {u}: card {a[:2]} cpu {b[:2]}")
                break
        raise SystemExit("the service's events on the card differ from the CPU's")
    if finals != S or max(errs.values()) > SERVING_REF_TOL:
        raise SystemExit("the service's final states on the card and the CPU disagree")
    return out


def tinyvad_graph(seed: int = 0):
    """An in-memory ONNX graph of TinyVadCNN's contract (the real export is
    not in the repository): input ``log_mel`` [N, 1, 32, 16], output
    ``logit`` [N, 1]; Conv, Relu, MaxPool, Flatten, Gemm with seeded
    weights.  The first convolution's bias (-0.05) is a dead zone that maps
    a window of silence (standardised to within a few 1e-3 of zero) to the
    Gemm's bias exactly, and the Gemm's positive weights give any sound a
    high probability.  The port's CPU tests run the same graph."""
    from moonshine_tpu_torch.core.onnx_io import OnnxGraph, OnnxNode

    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    inits = {"c1_w": w(8, 1, 3, 3), "c1_b": np.full(8, -0.05, np.float32),
             "c2_w": w(16, 8, 3, 3), "c2_b": np.zeros(16, np.float32),
             "fc_w": np.abs(w(1, 16 * 8 * 4)) * 4.0, "fc_b": np.asarray([-3.0], np.float32)}
    conv = {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}
    pool = {"kernel_shape": [2, 2], "strides": [2, 2]}
    nodes = [OnnxNode("Conv", ["log_mel", "c1_w", "c1_b"], ["h1"], attrs=conv),
             OnnxNode("Relu", ["h1"], ["r1"]), OnnxNode("MaxPool", ["r1"], ["p1"], attrs=pool),
             OnnxNode("Conv", ["p1", "c2_w", "c2_b"], ["h2"], attrs=conv),
             OnnxNode("Relu", ["h2"], ["r2"]), OnnxNode("MaxPool", ["r2"], ["p2"], attrs=pool),
             OnnxNode("Flatten", ["p2"], ["f"], attrs={"axis": 1}),
             OnnxNode("Gemm", ["f", "fc_w", "fc_b"], ["logit"], attrs={"transB": 1})]
    return OnnxGraph(nodes=nodes, initializers=inits, inputs=[("log_mel", ["batch", 1, 32, 16])],
                     outputs=[("logit", ["batch", 1])])


def phase_serving_vad(cfg, card: str) -> dict:
    """TinyVad over the contract graph, card against CPU: the masked
    batched probabilities of two successive calls (uneven valid counts,
    the rings carried) within VAD_PROB_TOL; then a float32 StreamingService
    with that VAD over a voiced stream (1 s of noise, then silence) and a
    silent one, on the card and on the CPU: the same segments and the same
    event times."""
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.models.vad import TinyVad
    from moonshine_tpu_torch.serving import StreamingService

    graph = tinyvad_graph(0)
    vads = {dev: TinyVad(graph, dev) for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(15)
    states = {dev: v.init_state(4) for dev, v in vads.items()}
    prob_err = 0.0
    for counts in ([16, 7, 0, 12], [3, 16, 9, 1]):
        hops = torch.from_numpy((rng.standard_normal((4, 16, 512)) * 0.1).astype(np.float32))
        probs = {}
        for dev, v in vads.items():
            probs[dev], states[dev] = v.predict_hops_masked(hops.to(dev), np.asarray(counts),
                                                            states[dev])
        valid = torch.arange(16)[None, :] < torch.as_tensor(counts)[:, None]
        prob_err = max(prob_err, float((probs["cuda"].cpu() - probs["cpu"])[valid].abs().max()))
    ring_err = float((states["cuda"].cols.cpu() - states["cpu"].cols).abs().max())

    model = ms.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    models = {"cuda": model, "cpu": copy.deepcopy(model).to("cpu")}
    voiced = np.concatenate([np.random.default_rng(16).standard_normal(16000) * 0.3,
                             np.zeros(32000)]).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        svc = StreamingService(models[dev], cfg, None, 2, vad=vads[dev], vad_threshold=0.5,
                               device=dev, **SERVING_KW)
        for i in range(2):
            svc.open_slot(i)
        events = []
        for u in range(12):
            svc.add_audio(0, voiced[u * 4000:(u + 1) * 4000])
            svc.add_audio(1, np.zeros(4000, np.float32))
            events += [(e.slot, e.segment_id, e.is_final, round(e.start_time, 6),
                        round(e.end_time, 6)) for e in svc.update()]
        segments = [[(round(g.start_time, 6), round(g.end_time, 6), g.is_complete)
                     for g in seg.segments] for seg in svc._segmenters]
        runs[dev] = (segments, events)
    same = runs["cuda"] == runs["cpu"]
    segments, events = runs["cpu"]
    log(f"  TinyVad (contract graph), card against cpu: probabilities max_abs_err {prob_err:.3e}, "
        f"rings {ring_err:.3e} (tolerance {VAD_PROB_TOL:g}); service segments and event times "
        f"equal {same}: voiced stream {segments[0]}, silent stream {segments[1]}, "
        f"{sum(e[2] for e in events)} finals; on {card}")
    if prob_err > VAD_PROB_TOL or ring_err > VAD_PROB_TOL or not same:
        raise SystemExit("TinyVad or the VAD service on the card disagrees with the CPU")
    if len(segments[0]) != 1 or not segments[0][0][2] or segments[1]:
        raise SystemExit("the VAD service did not cut one segment from the voiced stream alone")
    return {"prob_max_abs_err": prob_err, "ring_max_abs_err": ring_err, "segments": segments,
            "finals": sum(e[2] for e in events)}


def phase_streaming_bench(root: str, card: str) -> dict:
    """The port's eval/streaming_bench.run_bench at the bench's service
    size (medium_streaming, 64 streams in 2 cohorts) for 10 update periods
    of its default 0.5 s, over a synthetic 44 s wav (Gaussian noise at 0.1)
    in place of the reference recording."""
    from moonshine_tpu_torch.audio.wav import save_wav
    from moonshine_tpu_torch.eval.streaming_bench import run_bench

    path = os.path.join(root, "noise_16k.wav")
    save_wav(path, serving_audio(1)[0][:44 * SAMPLE_RATE], SAMPLE_RATE)
    torch.cuda.empty_cache()
    out = run_bench(model="medium_streaming", n_streams=64, n_cohorts=2, n_updates=10,
                    audio_path=path)
    log(f"  {json.dumps(out)} on {card}")
    if out["update_ms_p50"] <= 0 or out["n_updates"] != 10:
        raise SystemExit("the streaming bench did not run")
    return out


# [speakers and spelling]: Transcriber(model="base", identify_speakers) over
# a synthetic two-speaker conversation in 0.5 s chunks.  A pass every
# SPEAKER_UPDATE_S: the random-weight Base decodes to its token cap on
# every pass (about 10 ms a token), so a pass every 0.5 s would hold the
# phase for about a minute.  Activities and embeddings, card against CPU on
# the same weights and batches: float32 log-mel, convolutions with TF32
# off, a two-layer transformer; activities lie in [0, 1] and embeddings are
# unit vectors, so 1e-4 leaves two orders of magnitude over float32
# summation order (the port's CPU tests hold JAX to the same 1e-4).
CONVERSATION_SECONDS = 60.0
SPEAKER_UPDATE_S = 2.0
DIARIZATION_TOL = 1e-4
# [spelling]: logits of the spelling CNN and of SpellingOnnx over the
# contract graph, card against CPU (float32 convolutions, TF32 off).
SPELLING_TOL = 1e-4
SPELLING_CLIPS = 64


def synthetic_voice(seconds: float, f0: float, tilt: float, seed: int) -> np.ndarray:
    """A voiced sound: 15 harmonics of a fundamental f0 with 3 % vibrato,
    the k-th at 1/k**tilt, under a 4 Hz syllabic envelope, over faint
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 0.7 * t + seed)))
    phase /= SAMPLE_RATE
    tone = sum(np.sin(k * phase) / k ** tilt for k in range(1, 16))
    envelope = np.sqrt(np.clip(np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6)), 0, None))
    return (0.2 * tone * envelope + 0.003 * rng.standard_normal(t.size)).astype(np.float32)


def two_speaker_conversation(seconds: float = CONVERSATION_SECONDS, seed: int = 0):
    """(audio, truth): turns of 3-6 s that alternate between two synthetic
    voices (120 Hz with flat harmonics, 230 Hz with steep ones), 0.3-0.8 s
    of silence after each; truth lists (speaker, start, end) in seconds."""
    rng = np.random.default_rng(seed)
    parts, truth, n, speaker = [], [], 0, 0
    total = int(seconds * SAMPLE_RATE)
    while n < total:
        voice = synthetic_voice(rng.uniform(3.0, 6.0), (120.0, 230.0)[speaker],
                                (1.0, 1.8)[speaker], seed + len(parts))
        pause = np.zeros(int(SAMPLE_RATE * rng.uniform(0.3, 0.8)), np.float32)
        truth.append((speaker, n / SAMPLE_RATE, min(n + len(voice), total) / SAMPLE_RATE))
        parts += [voice, pause]
        n += len(voice) + len(pause)
        speaker ^= 1
    return np.concatenate(parts)[:total], truth


class Recorder:
    """Wraps a callback and keeps every call's arguments and result, and
    its wall seconds in ``seconds``."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, [], []

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.seconds.append(time.perf_counter() - t0)
        self.calls.append((args, out))
        return out


def linkage_margin(embeddings: np.ndarray, threshold: float) -> float:
    """The smallest |d - threshold| over the decisions that
    pipeline.diarization.cluster_embeddings takes on these embeddings
    (average linkage on cosine distance: merge while the closest pair of
    clusters is within the threshold), cluster distances updated by
    Lance-Williams."""
    e = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    d = (1.0 - e @ e.T).astype(np.float64)
    np.fill_diagonal(d, np.inf)
    sizes = np.ones(len(e))
    alive = np.ones(len(e), bool)
    margin = np.inf
    while alive.sum() > 1:
        masked = np.where(alive[:, None] & alive[None, :], d, np.inf)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        margin = min(margin, abs(masked[i, j] - threshold))
        if masked[i, j] > threshold:
            break
        d[i] = d[:, i] = (sizes[i] * d[i] + sizes[j] * d[j]) / (sizes[i] + sizes[j])
        d[i, i] = np.inf
        sizes[i] += sizes[j]
        alive[j] = False
    return float(margin)


def _turn_rows(turns) -> list:
    return [(t.speaker_id, t.speaker_index, round(t.start_time, 6),
             round(t.start_time + t.duration, 6)) for t in turns]


def phase_speakers(tokenizer_path: str, card: str, seed: int = 0) -> dict:
    """Transcriber(model="base").with_options(identify_speakers=True) on the
    card over a 60 s synthetic two-speaker conversation fed in 0.5 s
    chunks.  Then a SpeakerDiarizer on the CPU, with the same weights (the
    API's seeds), fed the same audio in the same pieces: every activity
    and embedding batch within DIARIZATION_TOL and the same turns (speaker
    IDs, start and end).  The device time of each model at the batches the
    diarizer used, the margins of the threshold decisions, and the DER
    against the synthetic truth (printed, not held: random weights)."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.eval.der import der
    from moonshine_tpu_torch.models import diarization as dm
    from moonshine_tpu_torch.pipeline import diarization as pd

    audio, truth = two_speaker_conversation(seed=seed)
    tr = Transcriber(model="base", tokenizer_path=tokenizer_path, seed=seed)
    tr.with_options(identify_speakers=True).load()
    diar = tr._pipeline.diarizer
    if tr.device.type != "cuda" or diar is None:
        raise SystemExit("the speaker-identifying Transcriber is not on cuda")
    diar.activities_fn = acts = Recorder(diar.activities_fn)
    diar.embedding_fn = embs = Recorder(diar.embedding_fn)
    fed, steps = [], []  # every add_audio's arguments; (wall s, its model calls)
    add_audio = diar.add_audio

    def recording_add_audio(sid, piece, sample_rate=SAMPLE_RATE):
        n_acts, n_embs = len(acts.calls), len(embs.calls)
        t0 = time.perf_counter()
        add_audio(sid, piece, sample_rate)
        fed.append((sid, piece))
        steps.append((time.perf_counter() - t0, acts.calls[n_acts:], embs.calls[n_embs:]))

    diar.add_audio = recording_add_audio
    clusterings = []
    cluster_embeddings = pd.cluster_embeddings

    def recording_clusters(e, threshold=0.7):
        clusterings.append((e.copy(), threshold))
        return cluster_embeddings(e, threshold)

    pd.cluster_embeddings = recording_clusters
    try:
        stream = tr.create_stream(update_interval=SPEAKER_UPDATE_S)
        stream.start()
        chunk = SAMPLE_RATE // 2
        t0 = time.perf_counter()
        for i in range(0, len(audio), chunk):
            stream.add_audio(audio[i:i + chunk])
        transcript = stream.stop()
        wall = time.perf_counter() - t0
        turns = diar.get_turns(stream.stream_id)
        tr.free_stream(stream)
    finally:
        pd.cluster_embeddings = cluster_embeddings

    # The same diarization on the CPU: weights drawn from the API's seeds.
    seg_cpu = dm.init_segmentation_params(torch.Generator().manual_seed(seed + 2), device="cpu")
    emb_cpu = dm.init_embedding_params(torch.Generator().manual_seed(seed + 3), device="cpu")
    cpu_acts = Recorder(lambda b: dm.segmentation_activations(seg_cpu, torch.from_numpy(b)).numpy())
    cpu_embs = Recorder(lambda b, w: dm.embedding_forward(
        emb_cpu, torch.from_numpy(b), torch.from_numpy(w)).numpy())
    ref = pd.SpeakerDiarizer(cpu_acts, cpu_embs)
    t0 = time.perf_counter()
    for sid, piece in fed:
        ref.add_audio(sid, piece)
    ref_turns = ref.finish_stream(stream.stream_id)
    cpu_s = time.perf_counter() - t0

    def max_err(card_calls, cpu_calls) -> float:
        if [c[1].shape for c in card_calls] != [c[1].shape for c in cpu_calls]:
            return float("inf")
        return max((float(np.abs(a[1] - b[1]).max()) for a, b in zip(card_calls, cpu_calls)),
                   default=0.0)

    act_err, emb_err = max_err(acts.calls, cpu_acts.calls), max_err(embs.calls, cpu_embs.calls)
    same_turns = _turn_rows(turns) == _turn_rows(ref_turns)
    act_margin = min(float(np.abs(out - pd.ACTIVITY_THRESHOLD).min()) for _, out in acts.calls)
    link_margin = min((linkage_margin(e, th) for e, th in clusterings), default=float("inf"))

    # Device time of each model at the batches the diarizer used.
    seg = dm.init_segmentation_params(torch.Generator().manual_seed(seed + 2), device="cuda")
    emb = dm.init_embedding_params(torch.Generator().manual_seed(seed + 3), device="cuda")
    seg_ms, emb_ms = {}, {}
    for (batch,), _ in acts.calls:
        if batch.shape[0] not in seg_ms:
            x = torch.from_numpy(batch).cuda()
            seg_ms[batch.shape[0]] = cuda_time_ms(lambda: dm.segmentation_activations(seg, x))
    for (batch, weights), _ in embs.calls:
        if batch.shape[0] not in emb_ms:
            x, w = torch.from_numpy(batch).cuda(), torch.from_numpy(weights).cuda()
            emb_ms[batch.shape[0]] = cuda_time_ms(lambda: dm.embedding_forward(emb, x, w))

    # An analysis step: a diarizer.add_audio that segmented new windows
    # (its model calls, their copies, the clustering), beside the device
    # time of its model calls at their batches.
    analysis = [(wall * 1e3, sum(seg_ms[a[0].shape[0]] for a, _ in a_calls)
                 + sum(emb_ms[e[0].shape[0]] for e, _ in e_calls))
                for wall, a_calls, e_calls in steps if a_calls]
    step_ms = float(np.median([w for w, _ in analysis]))
    step_device_ms = float(np.median([d for _, d in analysis]))
    lines = transcript.lines
    speakers = {s.speaker_id for line in lines for s in line.speaker_spans}
    windows = sum(args[0].shape[0] for args, _ in acts.calls)
    embedded = sum(args[0].shape[0] for args, _ in embs.calls)
    score = der(truth, turns)
    out = {"seconds": CONVERSATION_SECONDS, "update_interval_s": SPEAKER_UPDATE_S,
           "lines": len(lines), "lines_with_speakers": sum(bool(l.speaker_spans) for l in lines),
           "speakers": len(speakers), "turns": len(turns), "windows": windows,
           "activity_calls": len(acts.calls), "embeddings": embedded,
           "embedding_calls": len(embs.calls), "wall_s": wall, "cpu_diarizer_s": cpu_s,
           "segmentation_ms": seg_ms, "embedding_ms": emb_ms, "analysis_steps": len(analysis),
           "analysis_step_ms_p50": step_ms, "analysis_step_device_ms_p50": step_device_ms,
           "activities_max_abs_err": act_err, "embeddings_max_abs_err": emb_err,
           "turns_equal": same_turns, "activity_margin": act_margin,
           "linkage_margin": link_margin, "der": {k: v for k, v in score.items() if k != "mapping"}}
    log(f"  base + diarizer, {CONVERSATION_SECONDS:g} s in 0.5 s chunks, a pass every "
        f"{SPEAKER_UPDATE_S:g} s: {len(lines)} lines ({out['lines_with_speakers']} with speakers), "
        f"{len(speakers)} distinct speakers, {len(turns)} turns; {windows} windows segmented in "
        f"{len(acts.calls)} calls, {embedded} embeddings in {len(embs.calls)} calls; wall "
        f"{wall:.3f} s on {card}")
    log("  device ms (CUDA events, median of 7): segmentation_activations "
        + ", ".join(f"B={b}: {ms:.4f}" for b, ms in sorted(seg_ms.items()))
        + "; embedding_forward " + ", ".join(f"B={b}: {ms:.4f}" for b, ms in sorted(emb_ms.items()))
        + f"; an analysis step (median of {len(analysis)}) {step_ms:.3f} ms of wall, its model "
        f"calls {step_device_ms:.4f} ms of device ({step_device_ms / step_ms:.3f} of the wall)")
    log(f"  card against cpu (cpu diarizer {cpu_s:.2f} s): activities max_abs_err {act_err:.3e}, "
        f"embeddings {emb_err:.3e} (tolerance {DIARIZATION_TOL:g}); turns equal {same_turns}; "
        f"closest activity to its threshold {act_margin:.3e}, closest linkage decision "
        f"{link_margin:.3e}")
    log(f"  DER against the synthetic truth (random weights, not held): "
        + json.dumps(out["der"]))
    if not same_turns:
        for a, b in zip(_turn_rows(turns), _turn_rows(ref_turns)):
            if a != b:
                log(f"    first different turn: card {a}, cpu {b}")
                break
    if act_err > DIARIZATION_TOL or emb_err > DIARIZATION_TOL or not same_turns:
        raise SystemExit("the diarizer on the card disagrees with the CPU's")
    if not lines or not embedded or not out["lines_with_speakers"]:
        raise SystemExit("the diarizer embedded no speaker or no line carries a speaker")
    return out


def spelling_clips(n: int, seed: int = 17) -> np.ndarray:
    """[n, 16000]: 1 s clips, each a 0.3-0.7 s voiced burst at its own
    fundamental, placed at random in silence."""
    rng = np.random.default_rng(seed)
    clips = np.zeros((n, SAMPLE_RATE), np.float32)
    for i in range(n):
        burst = synthetic_voice(rng.uniform(0.3, 0.7), rng.uniform(90, 300), rng.uniform(0.8, 2),
                                seed + i)
        at = rng.integers(0, SAMPLE_RATE - len(burst))
        clips[i, at:at + len(burst)] = burst
    return clips


def spelling_graph(seed: int = 0):
    """An in-memory ONNX graph of SpellingCNN's contract (the real export
    is not in the repository): input ``mel`` [N, 1, 64, 128], output
    ``logits`` [N, 51]; MobileNetV2-style: a 3x3 stride-2 stem, two inverted
    residual blocks (1x1 expansion, 3x3 depthwise, 1x1 linear projection;
    the second strided 1 with its skip), batch norms, ReLU6 (Clip), a 1x1
    head convolution, a global average pool and a Gemm, seeded weights.
    The port's CPU tests run the same graph."""
    from moonshine_tpu_torch.core.onnx_io import OnnxGraph, OnnxNode

    rng = np.random.default_rng(seed)
    inits = {"relu6_lo": np.asarray(0.0, np.float32), "relu6_hi": np.asarray(6.0, np.float32)}
    nodes = []

    def conv(x, name, cin, cout, k=1, stride=1, group=1, act=True):
        inits[name + "_w"] = (rng.standard_normal((cout, cin // group, k, k))
                              * np.sqrt(2.0 / (cin // group * k * k))).astype(np.float32)
        inits[name + "_b"] = np.zeros(cout, np.float32)
        for part, v in (("s", 1 + 0.1 * rng.standard_normal(cout)),
                        ("o", 0.1 * rng.standard_normal(cout)),
                        ("m", 0.1 * rng.standard_normal(cout)),
                        ("v", rng.uniform(0.5, 1.5, cout))):
            inits[f"{name}_bn_{part}"] = v.astype(np.float32)
        p = k // 2
        nodes.append(OnnxNode("Conv", [x, name + "_w", name + "_b"], [name + "_c"],
                              attrs={"kernel_shape": [k, k], "strides": [stride, stride],
                                     "pads": [p, p, p, p], "group": group}))
        nodes.append(OnnxNode("BatchNormalization", [name + "_c"] + [
            f"{name}_bn_{part}" for part in "somv"], [name + "_n"], attrs={"epsilon": 1e-5}))
        if not act:
            return name + "_n"
        nodes.append(OnnxNode("Clip", [name + "_n", "relu6_lo", "relu6_hi"], [name]))
        return name

    h = conv("mel", "stem", 1, 16, k=3, stride=2)
    h = conv(h, "b1_expand", 16, 64)
    h = conv(h, "b1_dw", 64, 64, k=3, stride=2, group=64)
    h = conv(h, "b1_project", 64, 24, act=False)
    r = conv(h, "b2_expand", 24, 96)
    r = conv(r, "b2_dw", 96, 96, k=3, group=96)
    r = conv(r, "b2_project", 96, 24, act=False)
    nodes.append(OnnxNode("Add", [h, r], ["b2"]))
    h = conv("b2", "head", 24, 128)
    inits["fc_w"] = (rng.standard_normal((51, 128)) / np.sqrt(128)).astype(np.float32)
    inits["fc_b"] = np.zeros(51, np.float32)
    nodes += [OnnxNode("GlobalAveragePool", [h], ["pool"]),
              OnnxNode("Flatten", ["pool"], ["flat"], attrs={"axis": 1}),
              OnnxNode("Gemm", ["flat", "fc_w", "fc_b"], ["logits"], attrs={"transB": 1})]
    return OnnxGraph(nodes=nodes, initializers=inits, inputs=[("mel", ["batch", 1, 64, 128])],
                     outputs=[("logits", ["batch", 51])])


# The voice pack's decoder: latents of 64 values in tiles of PACK_TILE
# latents, 4 frames of 60 rows (48 log10 envelope knots, 12 aperiodicity
# bands) a latent (tts/neural_pack.py).  The pack itself, and with it its
# tile size, is not in the repository.
PACK_LATENT_DIM = 64
PACK_TILE = 16


def pack_decoder_graph(seed: int = 0):
    """An in-memory TFLite graph of the voice pack decoder's contract (the
    real s16x8 graph is not in the repository): input ``[1, PACK_TILE,
    64]`` latents, output ``[1, 4 * PACK_TILE, 60]`` frames, quantized as
    the pack's graph is (int8 per-channel weights, int64 biases and int16
    constants with their scales).  RESHAPE to NHWC rows, CONV_2D 1x3 and
    exact GELU, TRANSPOSE_CONV 1x8 at stride 4 with a fused ReLU,
    TRANSPOSE_CONV 1x4 at stride 2, tanh GELU, CONV_2D 1x3 at stride 2
    (XLA's uneven SAME padding), MUL and ADD by constants, two TRANSPOSEs
    and a RESHAPE back.  The port's CPU tests run the same graph."""
    from moonshine_tpu_torch.core.tflite_io import TfliteModel, TfliteOp, TfliteTensor

    rng = np.random.default_rng(seed)
    tensors: list = []

    def tensor(name, shape, data=None, scale=None, qdim=0):
        tensors.append(TfliteTensor(name, tuple(shape), np.dtype(np.float32 if data is None
                                                                 else data.dtype), data,
                                    None if scale is None else np.asarray(scale, np.float32),
                                    None, qdim))
        return len(tensors) - 1

    def ints(name, values):
        return tensor(name, [len(values)], np.asarray(values, np.int32))

    def weight(name, cout, kw, cin):  # int8, one scale per output channel
        scale = rng.uniform(0.5, 1.5, cout) / (127.0 * np.sqrt(kw * cin))
        q = rng.integers(-127, 128, (cout, 1, kw, cin)).astype(np.int8)
        return tensor(name, q.shape, q, scale)

    def bias(name, n):
        return tensor(name, [n], rng.integers(-2000, 2000, n).astype(np.int64), [1e-5])

    tl = PACK_TILE
    x = tensor("latents", [1, tl, PACK_LATENT_DIM])
    ops = []

    def op(name, ins, shape, **options):
        out = tensor(f"{name}_{len(ops)}", shape)
        ops.append(TfliteOp(name, ins, [out], options))
        return out

    h = op("RESHAPE", [x, ints("rows", [1, 1, tl, PACK_LATENT_DIM])], [1, 1, tl, PACK_LATENT_DIM])
    h = op("CONV_2D", [h, weight("c1_w", 128, 3, PACK_LATENT_DIM), bias("c1_b", 128)],
           [1, 1, tl, 128], padding=0, stride_w=1, stride_h=1)
    h = op("GELU", [h], [1, 1, tl, 128], approximate=0)
    # JAX's TRANSPOSE_CONV reads the weights' axis 0 as the input channels.
    h = op("TRANSPOSE_CONV", [ints("up1_shape", [1, 1, 4 * tl, 96]),
                              weight("up1_w", 128, 8, 96), h, bias("up1_b", 96)],
           [1, 1, 4 * tl, 96], padding=0, stride_w=4, stride_h=1, fused_activation=1)
    h = op("TRANSPOSE_CONV", [ints("up2_shape", [1, 1, 8 * tl, 64]),
                              weight("up2_w", 96, 4, 64), h, bias("up2_b", 64)],
           [1, 1, 8 * tl, 64], padding=0, stride_w=2, stride_h=1)
    h = op("GELU", [h], [1, 1, 8 * tl, 64], approximate=1)
    h = op("CONV_2D", [h, weight("c2_w", 60, 3, 64), bias("c2_b", 60)], [1, 1, 4 * tl, 60],
           padding=0, stride_w=2, stride_h=1)
    h = op("MUL", [h, tensor("gain", [60], rng.integers(8000, 16000, 60).astype(np.int16),
                             [1.0 / 8192])], [1, 1, 4 * tl, 60])
    h = op("ADD", [h, tensor("offset", [60], rng.integers(-4000, 4000, 60).astype(np.int16),
                             [1.0 / 4096])], [1, 1, 4 * tl, 60])
    h = op("RESHAPE", [h, ints("frames", [1, 4 * tl, 60])], [1, 4 * tl, 60])
    h = op("TRANSPOSE", [h, ints("to_rows", [0, 2, 1])], [1, 60, 4 * tl])
    h = op("TRANSPOSE", [h, ints("to_frames", [0, 2, 1])], [1, 4 * tl, 60])
    return TfliteModel(tensors=tensors, ops=ops, inputs=[x], outputs=[h])


def hifigan_graph(seed: int = 0, n_mels: int = 100, channels: int = 64):
    """An in-memory ONNX graph of a HiFiGAN-class vocoder in the voice
    cloner's vocoder.ort slot (a published export is not in the
    repository): input ``mel`` [N, 100, T], output ``wav`` [N, 1, 256 T]:
    a 7-tap pre-convolution, four LeakyReLU + ConvTranspose(8, stride 4)
    upsamplings that halve the channels, each followed by a dilated
    residual convolution, a 7-tap post-convolution and tanh; seeded
    weights."""
    from moonshine_tpu_torch.core.onnx_io import OnnxGraph, OnnxNode

    rng = np.random.default_rng(seed)
    inits, nodes = {}, []

    def conv(x, name, cin, cout, k, dilation=1):
        inits[name + "_w"] = (rng.standard_normal((cout, cin, k)) / np.sqrt(cin * k)).astype(
            np.float32)
        inits[name + "_b"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
        p = dilation * (k - 1) // 2
        nodes.append(OnnxNode("Conv", [x, name + "_w", name + "_b"], [name],
                              attrs={"kernel_shape": [k], "pads": [p, p],
                                     "dilations": [dilation]}))
        return name

    def leaky(x, name):
        nodes.append(OnnxNode("LeakyRelu", [x], [name], attrs={"alpha": 0.1}))
        return name

    h = conv("mel", "pre", n_mels, channels, 7)
    c = channels
    for i in range(4):
        u = leaky(h, f"up{i}_act")
        inits[f"up{i}_w"] = (rng.standard_normal((c, c // 2, 8)) / np.sqrt(c * 2)).astype(
            np.float32)
        inits[f"up{i}_b"] = np.zeros(c // 2, np.float32)
        nodes.append(OnnxNode("ConvTranspose", [u, f"up{i}_w", f"up{i}_b"], [f"up{i}"],
                              attrs={"kernel_shape": [8], "strides": [4], "pads": [2, 2]}))
        c //= 2
        r = conv(leaky(f"up{i}", f"res{i}_act"), f"res{i}", c, c, 3, dilation=3)
        nodes.append(OnnxNode("Add", [f"up{i}", r], [f"block{i}"]))
        h = f"block{i}"
    post = conv(leaky(h, "post_act"), "post", c, 1, 7)
    nodes.append(OnnxNode("Tanh", [post], ["wav"]))
    return OnnxGraph(nodes=nodes, initializers=inits, inputs=[("mel", ["batch", n_mels, "frames"])],
                     outputs=[("wav", ["batch", 1, "samples"])])


def phase_spelling(tokenizer_path: str, card: str, seed: int = 0) -> dict:
    """The spelling CNN (seeded weights) on SPELLING_CLIPS 1 s clips and
    SpellingOnnx over the contract graph, card against CPU (logits within
    SPELLING_TOL), each timed on the card at that batch; then a
    spelling-mode stream through the pipeline Transcriber with
    ``spelling_params`` on the card (Base, VAD off, 1 s segments): every
    completed line must carry what the fusion of its ASR text with the
    CPU's CNN prediction on its audio gives."""
    from moonshine_tpu_torch.core.config import BASE, TranscriberOptions, VadOptions
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.models import spelling as sp
    from moonshine_tpu_torch.pipeline.backends import OfflineBackend
    from moonshine_tpu_torch.pipeline.spelling import SpellingMatcher, fuse_default
    from moonshine_tpu_torch.pipeline.transcriber import FLAG_SPELLING_MODE, Transcriber

    clips = torch.from_numpy(spelling_clips(SPELLING_CLIPS))
    cnn = sp.init_params(torch.Generator().manual_seed(seed), device="cuda")
    cnn_cpu = copy.deepcopy(cnn).to("cpu")
    onnx = {dev: sp.SpellingOnnx(spelling_graph(seed), device=dev) for dev in ("cuda", "cpu")}
    x = clips.cuda()
    rows = {}
    for name, on_card, on_cpu in (
            ("cnn", lambda: sp.forward(cnn, x), lambda: sp.forward(cnn_cpu, clips)),
            ("onnx", lambda: onnx["cuda"].logits(x), lambda: onnx["cpu"].logits(clips))):
        card_logits, cpu_logits = on_card().cpu(), on_cpu()
        rows[name] = {"shape": list(card_logits.shape),
                      "max_abs_err": float((card_logits - cpu_logits).abs().max()),
                      "same_top1": int((card_logits.argmax(-1) == cpu_logits.argmax(-1)).sum()),
                      "finite": bool(card_logits.isfinite().all()),
                      "ms": cuda_time_ms(on_card)}
        log(f"  {name}: logits {tuple(card_logits.shape)} max_abs_err {rows[name]['max_abs_err']:.3e} "
            f"(tolerance {SPELLING_TOL:g}), top-1 equal on {rows[name]['same_top1']} of "
            f"{SPELLING_CLIPS}; {rows[name]['ms']:.4f} ms a batch of {SPELLING_CLIPS} on {card}")

    # A spelling-mode stream: Base on the card, the VAD off, 1 s segments.
    gen = torch.Generator().manual_seed(seed)
    backend = OfflineBackend(mm.init_params(BASE, gen, "cuda"), BASE,
                             BinTokenizer.from_file(tokenizer_path))
    asr_text = {}
    transcribe_segment = backend.transcribe_segment

    def recording(audio, segment_id, is_final):
        result = transcribe_segment(audio, segment_id, is_final)
        asr_text[segment_id] = result.text
        return result

    backend.transcribe_segment = recording
    opts = TranscriberOptions(model="base", vad=VadOptions(threshold=0.0, max_segment_duration=1.0))
    tr = Transcriber(backend, opts, spelling_params=cnn)
    audio = np.concatenate([np.concatenate([c, np.zeros(4000, np.float32)])
                            for c in spelling_clips(6, seed=18)])
    stream = tr.create_stream(update_interval=0.5, flags=FLAG_SPELLING_MODE)
    stream.start()
    t0 = time.perf_counter()
    for i in range(0, len(audio), SAMPLE_RATE // 2):
        stream.add_audio(audio[i:i + SAMPLE_RATE // 2])
    transcript = stream.stop()
    wall = time.perf_counter() - t0
    matcher = SpellingMatcher()
    completed = [line for line in transcript.lines if line.is_complete]
    expected = []
    for line in completed:
        text = asr_text[line.id]
        fused = fuse_default(text, matcher.classify(text), sp.predict(cnn_cpu, line.audio_data),
                             matcher)
        expected.append(fused.character if fused.is_character else text)
    got = [line.text for line in completed]
    log(f"  spelling-mode stream, {len(audio) / SAMPLE_RATE:g} s: {len(completed)} completed lines "
        f"{got}, as the CPU's fusion gives: {got == expected}; wall {wall:.3f} s on {card}")
    out = {**rows, "stream_lines": len(completed), "stream_texts": got,
           "stream_equal_cpu": got == expected, "stream_wall_s": wall}
    if any(r["max_abs_err"] > SPELLING_TOL or not r["finite"] for r in rows.values()):
        raise SystemExit("the spelling models on the card disagree with the CPU")
    if not completed or got != expected:
        raise SystemExit(f"the spelling-mode stream gave {got}, the CPU's fusion {expected}")
    return out


# -- the voice agent: EmbeddingGemma, AgentFlow, TTS, and the loop ---------

# Card against CPU, both float32 with TF32 off: EmbeddingGemma-300m's unit
# vectors after 24 layers (a match score is their cosine), the TTS durations
# after its 4-layer encoder and its waveform after 8 layers and the iSTFT
# (values of at most about 0.1).  tests/test_torch_gemma.py and test_torch_tts.py
# hold the port against JAX to the same limits on the CPU.
EMBED_TOL = 1e-5
DURATION_TOL = 1e-5
WAVEFORM_TOL = 1e-4
EMBED_SHAPES = ((1, 16), (1, 128), (1, 512), (64, 128))
# [embeddings]' document: 450 bytes; with the document prefix and [bos],
# [eos], 472 tokens of the byte tokenizer, in the 512 bucket.
DOCUMENT = ("The voice agent listens for a trigger phrase, asks its questions aloud, and "
            "matches each spoken answer against the phrases it expects by the cosine "
            "similarity of their sentence embeddings. A yes or a no confirms an order; a "
            "choice among drinks picks one option; a phrase that matches nothing is asked "
            "again, and a silence past the timeout brings a reprompt. Cancel ends the flow at "
            "once, and start over begins it again. The agent speaks every prompt.")
TRIGGERS = ("order a drink", "take the survey")
# After the trigger and a timeout: the Ask's answer, the Confirm's, the
# Choose's, a second trigger, a cancel, the trigger again and its answer.
CONVERSATION = ("alice", "yes", "espresso", "take the survey", "cancel", "take the survey",
                "good")
DRINKS = {"tea": ["a cuppa"], "coffee": ["espresso"]}


class ByteTokenizer:
    """One token a byte (ids 3-252), the tokenizer of the JAX package's
    Gemma tests: EmbeddingGemma's tokenizer.bin is not in the repository."""

    def text_to_tokens(self, text: str) -> list[int]:
        return [3 + (b % 250) for b in text.encode()]


def embedding_phrases() -> list[str]:
    """The flow's default yes and no phrases and the two triggers: 20."""
    from moonshine_tpu_torch.agent import flow

    return list(flow._DEFAULT_YES) + list(flow._DEFAULT_NO) + list(TRIGGERS)


def converse(flow_mod, embedder, cached_path=None) -> dict:
    """The scripted conversation through ``flow_mod.AgentFlow`` (the port's
    or the JAX package's ``agent/flow.py``) over ``embedder``, with a manual
    timer: a trigger, an Ask with a timeout reprompt, a Confirm, a Choose,
    a second flow cancelled and started again.  Returns the spoken prompts,
    the flows' results, the lines no trigger took, and every phrase match
    as (utterance, key, score, threshold)."""
    timers, spoken, results, other, matches = [], [], [], [], []

    class Timer:
        def __init__(self, timeout, callback):
            self.callback, self.cancelled = callback, False
            timers.append(self)

        def start(self):
            pass

        def cancel(self):
            self.cancelled = True

        def fire(self):
            if not self.cancelled:
                self.callback()

    def order(d):
        name = yield d.ask("what is your name?")
        ok = yield d.confirm(f"order for {name}?")
        drink = yield d.choose("which drink?", DRINKS)
        results.append(("order", name, ok, drink))
        yield d.say(f"one {drink} for {name}")

    def survey(d):
        results.append(("survey", (yield d.ask("how was it?"))))

    agent = flow_mod.AgentFlow().use_embedder(embedder)
    if cached_path is not None:
        agent.with_cached_embeddings(cached_path)
    agent.speak_with(spoken.append).timers_with(Timer).otherwise(other.append)
    agent.listen_for(TRIGGERS[0], order).listen_for(TRIGGERS[1], survey).load()
    matcher = flow_mod.PhraseMatcher
    inner = matcher.match_with_score

    def recording(self, utterance):
        key, score = inner(self, utterance)
        matches.append((utterance, key, float(score), self.threshold))
        return key, score

    matcher.match_with_score = recording
    try:
        agent.handle_utterance(TRIGGERS[0])
        if timers:
            timers[-1].fire()  # no answer: the reprompt
        for utterance in CONVERSATION:
            agent.handle_utterance(utterance)
    finally:
        matcher.match_with_score = inner
    return {"spoken": spoken, "results": results, "otherwise": other, "matches": matches}


def traced(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall, its kernels'
    summed device time, the device's idle share and the launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows)
    return {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "launches": sum(e.count for e in rows)}


def device_alone_ms(fn, runs: int = 7) -> dict:
    """CUDA-event times of ``fn``: as the device sees the call (``ms``, the
    host's enqueue included where it is the longer), and the device's work
    alone (``device_ms``: the card spins longer than the enqueue takes
    before each call), with the enqueue's host time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2_000_000 + 4e9 * enqueue_s)  # twice the enqueue at 2 GHz, and 1 ms
    return {"ms": cuda_time_ms(fn, runs=runs),
            "device_ms": cuda_time_ms(fn, runs=runs, before=lambda: torch.cuda._sleep(cycles)),
            "enqueue_ms": enqueue_s * 1e3}


def phase_embeddings(card: str, seed: int = 0) -> dict:
    """EmbeddingGemma-300m at full width (``GemmaTextConfig()``) from a
    seed, on the card and the same weights on the CPU: every phrase of
    ``embedding_phrases()`` plain and with the query prefix, and DOCUMENT
    with the document prefix (the 512 bucket), card against CPU within
    EMBED_TOL.  Then ``embed_tokens``' device time at EMBED_SHAPES, one
    [1, 16] call traced (idle share, launches), phrases/s through
    ``get_embeddings`` and the peak memory."""
    from moonshine_tpu_torch.models import gemma as gm

    cfg = gm.GemmaTextConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cpu_model = gm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    card_emb = gm.GemmaEmbedder(copy.deepcopy(cpu_model), cfg, ByteTokenizer(), device="cuda")
    cpu_emb = gm.GemmaEmbedder(cpu_model, cfg, ByteTokenizer(), device="cpu")
    build_s = time.perf_counter() - t0
    if not all(p.is_cuda for p in card_emb.params.parameters()):
        raise SystemExit("an EmbeddingGemma tensor is not on cuda")
    n_params = sum(p.numel() for p in card_emb.params.parameters())
    phrases = embedding_phrases()
    calls = ([("phrase", p, lambda e, p=p: e.get_embeddings(p)) for p in phrases]
             + [("query", p, lambda e, p=p: e.get_query_embeddings(p)) for p in phrases]
             + [("document", DOCUMENT, lambda e: e.get_document_embeddings(DOCUMENT))])
    errs, buckets = [], {}
    for kind, text, fn in calls:
        got, ref = fn(card_emb), fn(cpu_emb)
        if got.shape != (cfg.embedding_dim,) or not np.isfinite(got).all() \
                or abs(float(np.linalg.norm(got)) - 1.0) > 1e-5:
            raise SystemExit(f"the {kind} embedding of {text[:30]!r} is not a unit "
                             f"{cfg.embedding_dim}-vector")
        errs.append(float(np.abs(got - ref).max()))
        prefix = {"phrase": "", "query": gm.QUERY_PREFIX, "document": gm.DOCUMENT_PREFIX}[kind]
        bucket = card_emb.batch(prefix + text)[0].shape[1]
        buckets[bucket] = buckets.get(bucket, 0) + 1
    err = max(errs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in phrases:
        card_emb.get_embeddings(p)
    phrases_per_s = len(phrases) / (time.perf_counter() - t0)

    g = torch.Generator().manual_seed(seed + 1)
    times = {}
    for b, s in EMBED_SHAPES:
        tokens = torch.randint(3, 253, (b, s), generator=g).cuda()
        mask = torch.ones((b, s), dtype=torch.bool, device="cuda")
        fn = lambda: gm.embed_tokens(card_emb.params, cfg, tokens, mask)
        times[f"[{b}, {s}]"] = {**device_alone_ms(fn), **({"traced": traced(fn)} if (b, s) ==
                                                           EMBED_SHAPES[0] else {})}
    peak = torch.cuda.max_memory_allocated()
    small = times["[1, 16]"]
    out = {"params": n_params, "build_s": build_s, "embeddings": len(calls),
           "buckets": buckets, "max_abs_err": err, "tol": EMBED_TOL,
           "phrases_per_s": phrases_per_s, "embed_tokens": times, "peak_bytes": peak}
    log(f"  EmbeddingGemma-300m ({n_params / 1e6:.1f} M parameters, {cfg.num_layers} layers, "
        f"width {cfg.hidden_size}) "
        f"built on cpu and cuda in {build_s:.2f} s; {len(calls)} embeddings (buckets "
        f"{dict(sorted(buckets.items()))}): card against cpu max_abs_err {err:.3e} (tolerance "
        f"{EMBED_TOL:g}); {phrases_per_s:.1f} phrases/s through get_embeddings; peak "
        f"{peak / 1e9:.3f} GB on {card}")
    log("  embed_tokens device ms (CUDA events, median of 7; the call as the device sees it / "
        "the device alone / the host's enqueue): " + "; ".join(
            f"{k} {v['ms']:.4f} / {v['device_ms']:.4f} / {v['enqueue_ms']:.3f}"
            for k, v in times.items()))
    log(f"  one [1, 16] call traced: wall {small['traced']['wall_ms']:.3f} ms, kernels "
        f"{small['traced']['device_ms']:.3f} ms, idle share {small['traced']['idle_share']:.3f}, "
        f"{small['traced']['launches']} launches; by events, idle share "
        f"{1 - small['device_ms'] / small['ms']:.3f}")
    if err > EMBED_TOL:
        raise SystemExit("EmbeddingGemma on the card disagrees with the CPU's")
    if 512 not in buckets:
        raise SystemExit("the document did not land in the 512 bucket")
    out["embedders"] = (card_emb, cpu_emb)
    return out


def phase_agent(card_emb, cpu_emb, root: str) -> dict:
    """The scripted conversation (``converse``) on an AgentFlow over the
    card's embedder and on one over the CPU's: the same prompts, results
    and matched keys, every score within EMBED_TOL and printed with its
    margin to its threshold.  Then the conversation's constant phrases as
    a cached-embeddings TSV built on the card, reloaded: the same
    decisions."""
    from moonshine_tpu_torch.agent import cached_embeddings as ce
    from moonshine_tpu_torch.agent import flow

    t0 = time.perf_counter()
    card_run = converse(flow, card_emb)
    card_s = time.perf_counter() - t0
    cpu_run = converse(flow, cpu_emb)
    keys = lambda run: [(u, k, th) for u, k, _, th in run["matches"]]
    same = all(card_run[k] == cpu_run[k] for k in ("spoken", "results", "otherwise")) \
        and keys(card_run) == keys(cpu_run)
    score_err = max(abs(a[2] - b[2]) for a, b in zip(card_run["matches"], cpu_run["matches"]))
    log(f"  conversation on cuda ({card_s:.2f} s), {len(card_run['matches'])} phrase matches:")
    for u, k, s, th in card_run["matches"]:
        log(f"    {u!r} -> {k} score {s:.6f}, threshold {th:g}, margin {s - th:+.6f}")
    log(f"  spoken: {card_run['spoken']}")
    log(f"  results: {card_run['results']}; lines no trigger took: {card_run['otherwise']}")
    log(f"  card against cpu: the same prompts, results and keys {same}; scores max_abs_err "
        f"{score_err:.3e} (tolerance {EMBED_TOL:g})")
    if not same or score_err > EMBED_TOL:
        raise SystemExit("the agent over the card's embedder decides otherwise than the CPU's")
    expected = ["what is your name?", "Sorry, I didn't catch that. what is your name?",
                "order for alice?", "which drink?", "one coffee for alice", "how was it?",
                "how was it?"]
    if card_run["spoken"] != expected or card_run["results"] != [
            ("order", "alice", True, "coffee"), ("survey", "good")]:
        raise SystemExit("the scripted conversation took another path")

    phrases = sorted({*TRIGGERS, *flow._DEFAULT_YES, *flow._DEFAULT_NO, "cancel", "start over",
                      *DRINKS, *(p for v in DRINKS.values() for p in v)})
    path = os.path.join(root, "agent_phrases.tsv")
    built = ce.build_cached_embeddings(card_emb, phrases, path, {"model_name": "random gemma"})
    loaded, meta = ce.load_cached_embeddings(path)
    tsv_exact = all(np.array_equal(loaded[p], built[p]) for p in phrases)
    cached_run = converse(flow, card_emb, cached_path=path)
    cached_same = all(cached_run[k] == card_run[k] for k in ("spoken", "results", "otherwise")) \
        and keys(cached_run) == keys(card_run)
    log(f"  cached embeddings: {len(phrases)} phrases to a TSV on cuda ({meta}), read back "
        f"exactly {tsv_exact}; the conversation on the cache decides the same {cached_same}")
    if not (tsv_exact and cached_same):
        raise SystemExit("the cached-embeddings TSV changed the agent's decisions")
    return {"matches": card_run["matches"], "spoken": card_run["spoken"],
            "score_max_abs_err": score_err, "conversation_s": card_s,
            "cached_phrases": len(phrases)}


def phase_voice_loop(ea, tokenizer_path: str, card_emb, card: str, seed: int = 0) -> dict:
    """``TextToSpeech(language="en").load()`` (``TTSConfig()``) on the card
    over ``tts_intelligibility.DEFAULT_SENTENCES``, and the same weights and
    voice on the CPU: ``n_frames`` equal, durations within DURATION_TOL,
    waveforms within WAVEFORM_TOL.  The real-time factor, one synthesis's
    device time and launches.  Then the loop: ``evaluate(tts.synthesize,
    transcribe)`` through ``Transcriber(model="base")`` on the card (the
    24 kHz audio resampled inside ``transcribe``; K1 in every encode; the
    VAD off, ``vad_threshold=0``, as a random-weight VAD hears no speech in
    random-weight speech), each
    transcript fed to an AgentFlow that speaks through ``tts.say``, and the
    reference sentences after them as the flows' triggers.  The CER is
    printed, not held (random weights)."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.agent import flow
    from moonshine_tpu_torch.eval import tts_intelligibility as ti
    from moonshine_tpu_torch.models import tts as tm
    from moonshine_tpu_torch.tts.facade import TextToSpeech

    played = []
    tts = TextToSpeech(language="en", seed=seed).play_with(
        lambda wav, sr: played.append((len(wav), sr))).load()
    if tts.device.type != "cuda" or not all(p.is_cuda for p in tts.params.parameters()):
        raise SystemExit("the TextToSpeech model is not on cuda")
    voice = tts.voices[tts._voice_name]
    cpu_tts = TextToSpeech(
        params=tm.init_params(tts.cfg, torch.Generator().manual_seed(seed), "cpu"),
        device="cpu").load({tts._voice_name: voice})
    rows, synth_walls, audio_s = [], [], 0.0
    for text in ti.DEFAULT_SENTENCES:
        ipa = tts._g2p.text_to_ipa(text)
        (ph, n), (ph_cpu, _) = tts.phoneme_batch(ipa), cpu_tts.phoneme_batch(ipa)
        style = torch.from_numpy(np.asarray(voice, np.float32))
        got = tm.synthesize(tts.params, tts.cfg, ph, n, style.cuda())
        ref = tm.synthesize(cpu_tts.params, cpu_tts.cfg, ph_cpu, n, style)
        ends = float(ref.durations.cumsum(0)[-1])
        rows.append({"text": text, "phonemes": n, "n_frames": int(got.n_frames),
                     "cpu_n_frames": int(ref.n_frames),
                     "durations_err": float((got.durations.cpu() - ref.durations).abs().max()),
                     "waveform_err": float((got.waveform.cpu() - ref.waveform).abs().max()),
                     "ends_margin": abs(ends - (np.floor(ends) + 0.5))})
        t0 = time.perf_counter()
        wav, sr = tts.synthesize(text)
        synth_walls.append(time.perf_counter() - t0)
        audio_s += len(wav) / sr
        if not np.isfinite(wav).all() or len(wav) != int(got.n_frames) * tm.HOP:
            raise SystemExit(f"the synthesis of {text!r} is not finite or not its frames' length")
    rtf = sum(synth_walls) / audio_s
    ph, n = tts.phoneme_batch(tts._g2p.text_to_ipa(ti.DEFAULT_SENTENCES[0]))
    style = torch.from_numpy(np.asarray(voice, np.float32)).cuda()
    synth = lambda: tm.synthesize(tts.params, tts.cfg, ph, n, style)
    synth_ms = {**device_alone_ms(synth), "traced": traced(synth)}
    same_frames = all(r["n_frames"] == r["cpu_n_frames"] for r in rows)
    dur_err = max(r["durations_err"] for r in rows)
    wav_err = max(r["waveform_err"] for r in rows)
    log(f"  TTSConfig() on cuda, {len(rows)} sentences, {audio_s:.3f} s of 24 kHz audio in "
        f"{sum(synth_walls):.3f} s: real-time factor {rtf:.4f} (wall of synthesize over audio "
        f"seconds) on {card}")
    for r in rows:
        log(f"    {r['text']!r}: {r['phonemes']} phonemes, {r['n_frames']} frames (cpu "
            f"{r['cpu_n_frames']}), ends[-1] {r['ends_margin']:.6f} from the nearest half, "
            f"durations err {r['durations_err']:.3e}, waveform err {r['waveform_err']:.3e}")
    log(f"  one synthesize (sentence 1): {synth_ms['ms']:.4f} ms as the device sees it, "
        f"{synth_ms['device_ms']:.4f} ms device alone, enqueue {synth_ms['enqueue_ms']:.3f} ms; "
        f"traced: wall {synth_ms['traced']['wall_ms']:.3f} ms, kernels "
        f"{synth_ms['traced']['device_ms']:.3f} ms, idle share "
        f"{synth_ms['traced']['idle_share']:.3f}, {synth_ms['traced']['launches']} launches")
    log(f"  card against cpu: n_frames equal {same_frames}, durations max_abs_err {dur_err:.3e} "
        f"(tolerance {DURATION_TOL:g}), waveforms {wav_err:.3e} (tolerance {WAVEFORM_TOL:g})")
    if not same_frames or dur_err > DURATION_TOL or wav_err > WAVEFORM_TOL:
        raise SystemExit("the TTS on the card disagrees with the CPU's")

    tr = Transcriber(model="base", tokenizer_path=tokenizer_path).with_options(
        vad_threshold=0).load()
    if tr.device.type != "cuda":
        raise SystemExit("the loop's Transcriber is not on cuda")

    def transcribe(wav: np.ndarray, sr: int) -> str:
        return " ".join(line.text or "" for line in tr.transcribe(wav, sr).lines)

    said = []

    def flow_for(sentence):
        def run(d):
            yield d.say(f"you said {sentence}")
        return run

    agent = flow.AgentFlow().use_embedder(card_emb).speak_with(
        lambda text: (said.append(text), tts.say(text))).otherwise(
        lambda text: said.append(None))
    for sentence in ti.DEFAULT_SENTENCES:
        agent.listen_for(sentence, flow_for(sentence))
    agent.load()
    played.clear()
    launches0 = ea.encoder_attention_packed.launches
    t0 = time.perf_counter()
    res = ti.evaluate(tts.synthesize, transcribe)
    for _, hyp, _ in res.per_sentence:
        agent.handle_utterance(hyp)
    for sentence in ti.DEFAULT_SENTENCES:
        agent.handle_utterance(sentence)
    tts.wait()
    loop_s = time.perf_counter() - t0
    tts.stop()
    k1 = ea.encoder_attention_packed.launches - launches0
    spoken = [s for s in said if s is not None]
    log(f"  loop: {len(res.per_sentence)} sentences synthesized, transcribed by base on cuda and "
        f"fed to the agent in {loop_s:.3f} s; K1 {k1} launches; {res.summary()} (random weights, "
        f"not held)")
    for ref_text, hyp, c in res.per_sentence:
        log(f"    {c * 100:6.1f}%  {ref_text!r} -> {hyp[:60]!r}")
    log(f"  the agent spoke {len(spoken)} prompts through tts.say ({len(played)} played), "
        f"{said.count(None)} lines took no trigger")
    if not k1:
        raise SystemExit("K1 did not launch in the voice loop")
    if len(spoken) < len(ti.DEFAULT_SENTENCES) or len(played) != len(spoken):
        raise SystemExit("the agent's prompts were not all spoken through tts.say")
    return {"sentences": rows, "rtf": rtf, "audio_s": audio_s, "synthesize": synth_ms,
            "durations_max_abs_err": dur_err, "waveform_max_abs_err": wav_err,
            "cer": res.cer, "loop_s": loop_s, "k1_launches": k1, "agent_spoken": len(spoken),
            "played": len(played)}


# The code-only and published-pack voices, tok_pos and voice cloning, card
# against CPU with the limits the port's CPU tests hold them to against JAX
# (tests/test_torch_klatt.py, test_torch_tflite.py, test_torch_worldlite.py,
# test_torch_voice_clone.py, test_torch_tok_pos.py).
KLATT_REL_RMS = 2e-3  # RMS of the difference over the CPU waveform's RMS
KLATT_IPAS = ("sˈɛvən", "mˈuːn ʃˈaɪn")
PACK_TOL = 1e-5  # the decoder's rows, atol and rtol
PACK_FRAMES = 600  # 3 s of 5 ms WORLD-lite frames
PCM_STEPS = 2  # worldlite PCM, int16 steps
CLONE_SECONDS = 8.0
# The sampled mel (values up to about 6): cuBLAS's float32 products sum in
# another order than the CPU's, and guidance 3.0 scales the difference of
# the two branches at each of the 8 Euler steps.  The CPU tests hold the
# port to 2e-5 of JAX on one CPU; the card's first run read 4.196e-5 from
# the CPU's (PERF.md §6, PR 10), so the card is held to 2e-4.
CLONE_MEL_TOL = 2e-4
CLONE_WAV_TOL = 1e-4
CLONE_ONNX_TOL = (2e-4, 1e-3)  # atol, rtol of the OnnxVocoder head
PROMPT_MEL_TOL = (1e-4, 2e-4)  # compute_mel of the reference clip, atol, rtol
CLONE_TEXT = "the quick brown fox jumps over the lazy dog"
TOK_POS_TOL = 1e-5
TOK_POS_LINES = ("数学是研究数量、结构以及空间等概念的一门学科。", "我们明天去北京看长城。",
                 "今日は良い天気です。", "東京に行きます。", "アンパサンドは記号である。")


def rel_rms(ours: np.ndarray, ref: np.ndarray) -> float:
    d = np.sqrt(((ours - ref).astype(np.float64) ** 2).mean())
    return float(d / max(np.sqrt((ref.astype(np.float64) ** 2).mean()), 1e-30))


def phase_klatt(card: str) -> dict:
    """``TextToSpeech().voice("klatt")`` on the card over the five
    ``DEFAULT_SENTENCES`` and ``KlattTTS(deterministic_voice())`` on two
    IPA strings, each against the same on the CPU: equal sample counts,
    waveforms within KLATT_REL_RMS.  The real-time factor and one traced
    utterance."""
    from moonshine_tpu_torch.eval import tts_intelligibility as ti
    from moonshine_tpu_torch.tts import klatt as kl
    from moonshine_tpu_torch.tts.facade import TextToSpeech

    tts = TextToSpeech().voice("klatt").load()
    cpu = TextToSpeech(device="cpu").voice("klatt").load()
    rows, walls, audio_s = [], [], 0.0
    for text in ti.DEFAULT_SENTENCES:
        t0 = time.perf_counter()
        wav, sr = tts.synthesize(text)
        walls.append(time.perf_counter() - t0)
        ref, ref_sr = cpu.synthesize(text)
        audio_s += len(wav) / sr
        rows.append({"text": text, "samples": len(wav), "cpu_samples": len(ref), "sr": sr,
                     "rel_rms": rel_rms(wav, ref) if len(wav) == len(ref) else float("inf"),
                     "finite": bool(np.isfinite(wav).all())})
    if tts._klatt.device.type != "cuda":
        raise SystemExit("the Klatt voice is not on cuda")
    det_card = kl.KlattTTS(kl.deterministic_voice())
    det_cpu = kl.KlattTTS(kl.deterministic_voice(), device="cpu")
    for ipa in KLATT_IPAS:
        wav, ref = det_card.synthesize_ipa(ipa), det_cpu.synthesize_ipa(ipa)
        rows.append({"text": ipa, "samples": len(wav), "cpu_samples": len(ref), "sr": 22050,
                     "rel_rms": rel_rms(wav, ref) if len(wav) == len(ref) else float("inf"),
                     "finite": bool(np.isfinite(wav).all())})
    rtf = sum(walls) / audio_s
    first = ti.DEFAULT_SENTENCES[0]
    trace = traced(lambda: tts.synthesize(first))
    log(f"  klatt voice on cuda, {len(walls)} sentences, {audio_s:.3f} s of 22.05 kHz audio in "
        f"{sum(walls):.3f} s: real-time factor {rtf:.4f} on {card}")
    for r in rows:
        log(f"    {r['text'][:40]!r}: {r['samples']} samples (cpu {r['cpu_samples']}), "
            f"relative RMS error {r['rel_rms']:.3e}")
    log(f"  one synthesize (sentence 1) traced: wall {trace['wall_ms']:.3f} ms, kernels "
        f"{trace['device_ms']:.3f} ms, idle share {trace['idle_share']:.3f}, "
        f"{trace['launches']} launches")
    worst = max(r["rel_rms"] for r in rows)
    log(f"  card against cpu: sample counts equal "
        f"{all(r['samples'] == r['cpu_samples'] for r in rows)}, worst relative RMS error "
        f"{worst:.3e} (tolerance {KLATT_REL_RMS:g})")
    if (any(r["samples"] != r["cpu_samples"] or r["sr"] != 22050 or not r["finite"]
            for r in rows) or worst > KLATT_REL_RMS):
        raise SystemExit("the Klatt voice on the card disagrees with the CPU's")
    return {"rows": rows, "rtf": rtf, "audio_s": audio_s, "wall_s": sum(walls),
            "traced": trace, "worst_rel_rms": worst}


def phase_pack_decoder_and_worldlite(card: str, seed: int = 0) -> dict:
    """The pack decoder's contract graph through ``TfliteExecutor`` on the
    card, every tile of a 3 s utterance in one batch, against the CPU's;
    then ``worldlite.render`` of those 600 frames with one noise draw
    injected into both, card against CPU."""
    from moonshine_tpu_torch.ops.tflite_graph import TfliteExecutor
    from moonshine_tpu_torch.tts import neural_pack as npk
    from moonshine_tpu_torch.tts import worldlite as wl

    model = pack_decoder_graph(seed)
    ex, ex_cpu = TfliteExecutor(model), TfliteExecutor(model, "cpu")
    if ex.device.type != "cuda" or not all(t.is_cuda for t in ex.consts.values()):
        raise SystemExit("the TFLite executor's constants are not on cuda")
    rng = np.random.default_rng(seed)
    n_tiles = -(-PACK_FRAMES // (4 * PACK_TILE))
    tiles = (rng.standard_normal((n_tiles, PACK_TILE, PACK_LATENT_DIM)) * 0.5).astype(np.float32)
    rows = npk.decode_tiles(ex, tiles)
    ref = npk.decode_tiles(ex_cpu, tiles)
    dec_err = float(np.abs(rows - ref).max())
    dec_ok = bool(np.isfinite(rows).all()) and np.allclose(rows, ref, atol=PACK_TOL, rtol=PACK_TOL)
    x = torch.from_numpy(tiles).cuda()
    dec_ms = device_alone_ms(lambda: ex.run(x))

    track = rows.reshape(-1, 60)[:PACK_FRAMES]
    n = np.arange(PACK_FRAMES)
    f0 = np.where(n % 120 < 90, 120 + 30 * np.sin(n / 25), 0).astype(np.float32)
    benv = np.power(10.0, np.clip(track[:, :48], -3, 1) - 2).astype(np.float32)
    bap = np.clip(track[:, 48:] * 0.5 + 0.5, 0.0, 1.0)
    plan = wl.pulse_plan(f0)
    pulses = len(plan["pulse_index"])
    noise = torch.randn((pulses, wl.MAX_NOISE), generator=torch.Generator().manual_seed(seed))
    pcm = wl.render(benv, bap, f0, 0.8, noise=noise)
    pcm_cpu = wl.render(benv, bap, f0, 0.8, noise=noise, device="cpu")
    steps = int(np.abs(pcm.astype(np.int32) - pcm_cpu.astype(np.int32)).max())
    render = lambda: wl.render(benv, bap, f0, 0.8, noise=noise)
    render()
    torch.cuda.synchronize()
    render_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        render()  # the PCM comes back to the host: the wall is complete
        render_walls.append((time.perf_counter() - t0) * 1e3)
    trace = traced(render)
    log(f"  decoder: {n_tiles} tiles of {PACK_TILE} latents in one batch -> {rows.shape}, "
        f"{dec_ms['ms']:.4f} ms as the device sees it, {dec_ms['device_ms']:.4f} ms device "
        f"alone; card against cpu max_abs_err {dec_err:.3e} (tolerance {PACK_TOL:g}) on {card}")
    log(f"  worldlite.render: {PACK_FRAMES} frames, {pulses} pulses, "
        f"{wl.overlap_sets(plan['pulse_index'])} overlap sets, {len(pcm)} samples in "
        f"{statistics.median(render_walls):.3f} ms wall (median of 5); traced: kernels "
        f"{trace['device_ms']:.3f} ms, idle share {trace['idle_share']:.3f}, "
        f"{trace['launches']} launches; card against cpu {steps} int16 steps (tolerance "
        f"{PCM_STEPS}), peak {int(np.abs(pcm).max())}")
    log("  NeuralPackTTS end to end waits for the voice pack, which is not in the repository "
        "(not a phase of this run)")
    if not dec_ok or steps > PCM_STEPS or len(pcm) != PACK_FRAMES * wl.FRAME_SAMPLES:
        raise SystemExit("the pack decoder or worldlite on the card disagrees with the CPU's")
    return {"decoder_max_abs_err": dec_err, "decoder": dec_ms, "tiles": n_tiles,
            "pulses": pulses, "pcm_steps": steps, "render_ms": statistics.median(render_walls),
            "render_traced": trace}


def clone_speech(seed: int = 0) -> np.ndarray:
    """CLONE_SECONDS of the port's TextToSpeech on the card (random weights
    from ``seed``), the DEFAULT_SENTENCES in turn, resampled to 16 kHz."""
    from moonshine_tpu_torch.audio.resample import resample_audio
    from moonshine_tpu_torch.eval import tts_intelligibility as ti
    from moonshine_tpu_torch.tts.facade import TextToSpeech

    tts = TextToSpeech(seed=seed).load()
    pieces, total, i = [], 0, 0
    while total < CLONE_SECONDS * SAMPLE_RATE:
        wav, sr = tts.synthesize(ti.DEFAULT_SENTENCES[i % len(ti.DEFAULT_SENTENCES)])
        pieces.append(resample_audio(wav, sr, SAMPLE_RATE))
        total += len(pieces[-1])
        i += 1
    return np.concatenate(pieces)[: int(CLONE_SECONDS * SAMPLE_RATE)].astype(np.float32)


def phase_voice_clone(ea, tokenizer_path: str, card: str, seed: int = 0) -> dict:
    """Capture: ``VoiceClone`` on CLONE_SECONDS of the port's TTS speech fed
    in 0.5 s chunks, with a constant speech probability (as the JAX test
    does: a random-weight VAD hears no speech in random speech).  Clip
    words: ``Transcriber(model="base")`` with word timestamps on the card
    (the VAD off; K1 in every encode) gives ``finalize(words=...)``.
    Synthesis: ``VoiceCloner()`` at ``CloneConfig()`` says CLONE_TEXT with
    the iSTFT head and with an ``OnnxVocoder`` over ``hifigan_graph()``;
    its mel and waveforms against a CPU cloner with the same weights,
    prompt and latent."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.models import voice_clone as vc
    from moonshine_tpu_torch.models.tts_onnx import OnnxVocoder
    from moonshine_tpu_torch.tts.g2p import GraphemeToPhonemizer
    from moonshine_tpu_torch.tts.voice_clone_api import VoiceClone

    speech = clone_speech(seed)
    cloner = vc.VoiceCloner()
    if not all(p.is_cuda for p in cloner.params.parameters()):
        raise SystemExit("the voice cloner is not on cuda")
    session = VoiceClone(lambda hops: np.ones(hops.shape[0], np.float32), cloner)
    chunk = SAMPLE_RATE // 2
    progress = [session.add_audio(speech[i:i + chunk]) for i in range(0, len(speech), chunk)]
    if not progress[-1].ready:
        raise SystemExit("VoiceClone did not capture a complete clip")

    tr = Transcriber(model="base", tokenizer_path=tokenizer_path).with_options(
        vad_threshold=0, word_timestamps=True).load()
    if tr.device.type != "cuda":
        raise SystemExit("the clip's Transcriber is not on cuda")
    launches0 = ea.encoder_attention_packed.launches
    t0 = time.perf_counter()
    words = [w for line in tr.transcribe(speech).lines for w in line.words]
    asr_s = time.perf_counter() - t0
    k1 = ea.encoder_attention_packed.launches - launches0
    if not words:
        raise SystemExit("the clip's transcription gave no word times")
    clip = session.finalize(words=words)
    log(f"  capture: {len(progress)} chunks of 0.5 s, ready after "
        f"{next(i for i, p in enumerate(progress) if p.ready) + 1}; {len(words)} words in "
        f"{asr_s:.3f} s, K1 {k1} launches; clip {clip.audio.size / SAMPLE_RATE:.3f} s from "
        f"{clip.start_time_seconds:.2f} s, transcript {session.transcript[:50]!r}")

    # The CPU cloner takes the card's prompt, so that the two sample the
    # same ODE; compute_mel of the clip is compared on its own.
    cpu = vc.VoiceCloner(copy.deepcopy(cloner.params).to("cpu"), device="cpu")
    cpu.set_reference(clip.audio, session.transcript, SAMPLE_RATE)
    prompt_err = float(np.abs(cloner._prompt_mel - cpu._prompt_mel).max())
    prompt_ok = np.allclose(cloner._prompt_mel, cpu._prompt_mel, atol=PROMPT_MEL_TOL[0],
                            rtol=PROMPT_MEL_TOL[1])
    cpu._prompt_mel, cpu._prompt_ipa = cloner._prompt_mel, cloner._prompt_ipa
    ipa = GraphemeToPhonemizer("en").text_to_ipa(CLONE_TEXT)
    x0 = vc.initial_latent(cloner.seed, vc.MAX_FRAMES)
    mel, prompt_frames, total = cloner.mel_from_ipa(ipa, x0=x0)
    mel_cpu, _, _ = cpu.mel_from_ipa(ipa, x0=x0)
    mel_err = float((mel.cpu() - mel_cpu).abs().max())
    wav = cloner.synthesize_from_ipa(ipa, x0=x0)
    wav_cpu = cpu.synthesize_from_ipa(ipa, x0=x0)
    wav_err = float(np.abs(wav - wav_cpu).max()) if wav.shape == wav_cpu.shape else float("inf")
    graph = hifigan_graph(seed)
    cloner.vocoder, cpu.vocoder = OnnxVocoder(graph), OnnxVocoder(graph, "cpu")
    onnx_wav = cloner.synthesize_from_ipa(ipa, x0=x0)
    onnx_cpu = cpu.synthesize_from_ipa(ipa, x0=x0)
    onnx_ok = onnx_wav.shape == onnx_cpu.shape and np.allclose(
        onnx_wav, onnx_cpu, atol=CLONE_ONNX_TOL[0], rtol=CLONE_ONNX_TOL[1])
    onnx_err = (float(np.abs(onnx_wav - onnx_cpu).max()) if onnx_wav.shape == onnx_cpu.shape
                else float("inf"))
    cloner.vocoder = None

    say = lambda: session.say(CLONE_TEXT)
    say()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = say()  # numpy back on the host: the wall is complete
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    rtf = wall / (len(out) / vc.SAMPLE_RATE)
    trace = traced(say)
    sample = lambda: cloner.mel_from_ipa(ipa, x0=x0)
    sample_ms = device_alone_ms(sample, runs=3)
    log(f"  synthesis, CloneConfig() on cuda: {len(out)} samples ({len(out) / vc.SAMPLE_RATE:.3f}"
        f" s at 24 kHz, {total - prompt_frames} frames after a {prompt_frames}-frame prompt) in "
        f"{wall * 1e3:.3f} ms wall (median of 3): real-time factor {rtf:.4f} on {card}")
    log(f"  one say traced: wall {trace['wall_ms']:.3f} ms, kernels {trace['device_ms']:.3f} ms, "
        f"idle share {trace['idle_share']:.3f}, {trace['launches']} launches; the 8-step sample "
        f"alone {sample_ms['ms']:.3f} ms as the device sees it, {sample_ms['device_ms']:.3f} ms "
        "device alone")
    log(f"  card against cpu: prompt mel {prompt_err:.3e} (tolerance {PROMPT_MEL_TOL}), sampled "
        f"mel {mel_err:.3e} (tolerance {CLONE_MEL_TOL:g}), waveform {wav_err:.3e} (tolerance "
        f"{CLONE_WAV_TOL:g}), OnnxVocoder waveform {onnx_err:.3e} (tolerance {CLONE_ONNX_TOL})")
    if not k1:
        raise SystemExit("K1 did not launch in the clone session's transcription")
    if (not prompt_ok or mel_err > CLONE_MEL_TOL or wav_err > CLONE_WAV_TOL or not onnx_ok
            or not np.isfinite(out).all() or len(out) == 0):
        raise SystemExit("the voice cloner on the card disagrees with the CPU's")
    return {"k1_launches": k1, "words": len(words), "asr_s": asr_s,
            "clip_s": clip.audio.size / SAMPLE_RATE, "prompt_mel_max_abs_err": prompt_err,
            "mel_max_abs_err": mel_err, "wav_max_abs_err": wav_err,
            "onnx_wav_max_abs_err": onnx_err, "synth_wall_ms": wall * 1e3, "rtf": rtf,
            "traced": trace, "sample": sample_ms}


def phase_tok_pos(card: str, seed: int = 0) -> dict:
    """``TokPosTagger`` at ``TokPosConfig()`` with weights from ``seed`` on
    the card, against the same weights on the CPU: equal annotations on zh
    and ja lines, logits within TOK_POS_TOL."""
    from moonshine_tpu_torch.tts import tok_pos as tp

    cfg = tp.TokPosConfig()
    vocab = sorted({c for line in TOK_POS_LINES for c in line})
    tags = ["NOUN", "VERB", "ADJ", "ADP", "PUNCT", "PRON", "ADV", "AUX", "PART", "PROPN", "NUM"]
    model = tp.init_params(cfg, torch.Generator().manual_seed(seed), len(vocab) + 2, len(tags))
    tagger = tp.TokPosTagger(cfg, model, vocab, tags)
    cpu = tp.TokPosTagger(cfg, copy.deepcopy(model).to("cpu"), vocab, tags, device="cpu")
    same, err = True, 0.0
    for line in TOK_POS_LINES:
        for a, b in zip(tagger.logits(line), cpu.logits(line)):
            err = max(err, float((a.cpu() - b).abs().max()))
        same &= tagger.annotate(line) == cpu.annotate(line)
    ms = device_alone_ms(lambda: tagger.logits(TOK_POS_LINES[0]))
    log(f"  TokPosConfig() on cuda, {len(TOK_POS_LINES)} zh and ja lines: annotations equal "
        f"{same}, logits max_abs_err {err:.3e} (tolerance {TOK_POS_TOL:g}); one line "
        f"{ms['ms']:.4f} ms as the device sees it on {card}; first line "
        f"{tagger.segment(TOK_POS_LINES[0])[:4]}")
    if not same or err > TOK_POS_TOL:
        raise SystemExit("the tok_pos tagger on the card disagrees with the CPU's")
    return {"annotations_equal": same, "logits_max_abs_err": err, "line": ms}


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
    from moonshine_tpu_torch.core.config import BASE, STREAMING_ARCHS, TINY
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
    max_err = phase_kernel_vs_plain(ea, BASE)
    log("[kernel vs plain] K2")
    hm_err = phase_hm_vs_plain(ea)
    log("[kernel vs plain] K1, K2 batch independence")
    batch_independence = phase_batch_independence(ea)
    log("[kernel vs plain] K3, K4")
    gather_err = phase_gather_vs_plain(bg)
    log("[kernel SASS] K1, K2")
    sass = phase_sass(_build)
    log("[kernel times] K1")
    times = phase_kernel_times(ea)
    log("[kernel times] K2")
    hm_times = phase_hm_times(ea)
    log("[kernel times] K1, K2 float32")
    f32_times = phase_f32_times(ea)
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
        log("[speculative reference]")
        spec_ref = phase_speculative_reference(model, BASE, TINY)
        log("[w8a8 main path] Transcriber(model='base').with_params(w8a8 Base) on cuda")
        w8a8_main = phase_w8a8_main_path(ea, tok_path, model, BASE)
        log("[checkpoint and catalog] Transcriber('base', 'en') from MOONSHINE_TPU_CACHE")
        catalog_root = os.path.join(tmp, "cache")
        os.makedirs(catalog_root)
        checkpoint = phase_checkpoint(ea, tok_path, model, BASE, catalog_root)
        del model
        log("[batched offline decode]")
        batched = phase_batched(ea, BASE, args.batch, card)
        log("[w8a8 batched] the bench's --w8a8 mode")
        w8a8_batched = phase_batched(ea, BASE, args.batch, card, w8a8=True)
        log(f"  w8a8 {w8a8_batched['audio_s_per_s']:.2f} audio-s/s beside float "
            f"{batched['audio_s_per_s']:.2f} ({w8a8_batched['audio_s_per_s'] / batched['audio_s_per_s']:.3f}x)")
        log("[batched beam]")
        beam = phase_beam(ea, bg, BASE, args.beam_batch, card)
        log("[sharded path]")
        sharded = phase_sharded(ea, bg, BASE, TINY, args.batch, card)
        log("[speculative]")
        speculative = phase_speculative(BASE, TINY, SPEC_BATCH, card)
        log("[eval harness]")
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        evaluation = phase_eval(bg, BASE, tok_path, corpus, card)
        log("[streaming] Transcriber(model='medium_streaming') on cuda, through a stream")
        streaming = phase_streaming(tok_path, card)
        log("[streaming reference]")
        streaming_ref = phase_streaming_reference(STREAMING_ARCHS["medium_streaming"])
        # The service's paths run no kernel of the repository (the JAX
        # service is XLA code): each one's counts are read over its own run.
        serving_launches = {}
        log("[serving] ShardedStreamingService, the bench's headline configuration")
        reset_launches(ea, bg)
        serving = phase_serving(card)
        serving_launches["serving"] = kernel_launches(ea, bg)
        log("[serving reference]")
        reset_launches(ea, bg)
        serving_ref = phase_serving_reference(STREAMING_ARCHS["medium_streaming"], card)
        serving_launches["serving reference"] = kernel_launches(ea, bg)
        log("[serving vad]")
        reset_launches(ea, bg)
        serving_vad = phase_serving_vad(STREAMING_ARCHS["medium_streaming"], card)
        serving_launches["serving vad"] = kernel_launches(ea, bg)
        log("[streaming bench] eval/streaming_bench.run_bench")
        reset_launches(ea, bg)
        streaming_bench = phase_streaming_bench(tmp, card)
        serving_launches["streaming bench"] = kernel_launches(ea, bg)
        log(f"  kernel launches on the service's paths: {serving_launches}")
        # Speaker identification and spelling run Base's encoder (K1) under
        # models that are XLA code in the JAX package (no Pallas).
        log("[speakers and spelling] Transcriber(model='base', identify_speakers=True) on cuda")
        reset_launches(ea, bg)
        speakers = phase_speakers(tok_path, card)
        speaker_launches = {"speakers and spelling": kernel_launches(ea, bg)}
        log("[spelling] the spelling CNN, SpellingOnnx and a spelling-mode stream on cuda")
        reset_launches(ea, bg)
        spelling = phase_spelling(tok_path, card)
        speaker_launches["spelling"] = kernel_launches(ea, bg)
        log(f"  kernel launches: {speaker_launches}")
        if not speaker_launches["speakers and spelling"]["encoder_attention_packed"]:
            raise SystemExit("K1 did not launch on the speaker-identifying path")
        # The voice agent: EmbeddingGemma, the TTS model and the G2P
        # transformer are XLA code in the JAX package (no Pallas); the
        # loop's ASR runs K1 in every encode.
        log("[embeddings] EmbeddingGemma-300m at full width on cuda, card against cpu")
        t_voice = time.perf_counter()
        reset_launches(ea, bg)
        embeddings = phase_embeddings(card)
        card_emb, cpu_emb = embeddings.pop("embedders")
        voice_launches = {"embeddings": kernel_launches(ea, bg)}
        log("[agent] AgentFlow over the card's and the cpu's embedder")
        reset_launches(ea, bg)
        agent = phase_agent(card_emb, cpu_emb, tmp)
        voice_launches["agent"] = kernel_launches(ea, bg)
        del cpu_emb
        log("[tts and voice loop] TextToSpeech on cuda; TTS -> Transcriber(model='base') -> agent")
        reset_launches(ea, bg)
        voice = phase_voice_loop(ea, tok_path, card_emb, card)
        voice_launches["voice loop"] = kernel_launches(ea, bg)
        del card_emb
        voice["phases_s"] = time.perf_counter() - t_voice
        log(f"  kernel launches: {voice_launches}; the three voice-agent phases took "
            f"{voice['phases_s']:.1f} s")
        # The code-only and pack voices, tok_pos and the cloner are XLA
        # code in the JAX package (no Pallas); the clone session's
        # transcription runs K1 in every encode.
        t_item12 = time.perf_counter()
        log("[klatt] TextToSpeech().voice('klatt') and KlattTTS on cuda, card against cpu")
        reset_launches(ea, bg)
        klatt = phase_klatt(card)
        item12_launches = {"klatt": kernel_launches(ea, bg)}
        log("[neural pack decoder and worldlite] TfliteExecutor and worldlite.render on cuda")
        reset_launches(ea, bg)
        pack = phase_pack_decoder_and_worldlite(card)
        item12_launches["neural pack decoder and worldlite"] = kernel_launches(ea, bg)
        log("[voice clone] VoiceClone capture, Transcriber(model='base') word times, "
            "VoiceCloner on cuda")
        reset_launches(ea, bg)
        clone = phase_voice_clone(ea, tok_path, card)
        item12_launches["voice clone"] = kernel_launches(ea, bg)
        log("[tok_pos] TokPosTagger on cuda, card against cpu")
        reset_launches(ea, bg)
        tok_pos = phase_tok_pos(card)
        item12_launches["tok_pos"] = kernel_launches(ea, bg)
        item12_s = time.perf_counter() - t_item12
        log(f"  kernel launches: {item12_launches}; the four phases took {item12_s:.1f} s")
        if not item12_launches["voice clone"]["encoder_attention_packed"]:
            raise SystemExit("K1 did not launch on the voice clone path")

    k3, k4 = gather_times["K3 int8"], gather_times["K4"]
    k3_bf16 = gather_times["K3 bf16"]

    def f32_fields(name: str) -> dict:
        """The float32 timings of one kernel: the 16 s bucket's as f32_*,
        and every shape's in f32_shapes."""
        rows = [r for r in f32_times.values() if r["kernel"] == name]
        main = next(r for r in rows if r["shape"][1] == 665)
        return {"f32_shape": main["shape"], "f32_ms": main["kernel_ms"],
                "f32_plain_ms": main["plain_ms"], "f32_library_ms": main["library_ms"],
                "f32_bound_ms": main["bound_ms"], "f32_bound_by": main["bound_by"],
                "f32_shapes": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by")} for r in rows]}

    # K1's launches on every path that runs it, each counted over its own
    # run (the comparisons with the plain version are not counted).
    k1_by_path = {"main path": main_launches, "w8a8 main path": w8a8_main["k1_launches"],
                  "checkpoint and catalog": checkpoint["k1_launches"],
                  "batched offline decode": batched["k1_launches"],
                  "w8a8 batched": w8a8_batched["k1_launches"],
                  "batched beam": beam["launches"]["encoder_attention_packed"],
                  "sharded path": sharded["launches"]["encoder_attention_packed"]}

    def on_counted_paths(kernel: str) -> dict:
        return {path: counts[kernel]
                for path, counts in {**serving_launches, **speaker_launches,
                                     **voice_launches, **item12_launches}.items()}

    k1_by_path.update(on_counted_paths("encoder_attention_packed"))
    kernels = [{
        "name": "encoder_attention_packed", "route": "cuda",
        "source": "moonshine_tpu_torch/csrc/encoder_attention.cu",
        "replaces": "moonshine_tpu/ops/encoder_attention.py:111",
        "launches": sum(k1_by_path.values()), "launches_by_path": k1_by_path,
        "max_abs_err": max_err,
        "tol": {k: list(TOL[getattr(torch, k)]) for k in ("float32", "bfloat16")},
        "ms": times["kernel_ms"], "kernel_ms": times["kernel_ms"],
        "plain_ms": times["plain_ms"], "library_ms": times["library_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"], **f32_fields("K1"),
    }, {
        "name": "encoder_attention", "route": "cuda",
        "source": "moonshine_tpu_torch/csrc/encoder_attention.cu",
        "replaces": "moonshine_tpu/ops/encoder_attention.py:43",
        "launches": sharded["launches"]["encoder_attention"],
        "launches_by_path": {"sharded path": sharded["launches"]["encoder_attention"],
                             **on_counted_paths("encoder_attention")},
        "max_abs_err": hm_err,
        "tol": {k: list(TOL[getattr(torch, k)]) for k in ("float32", "bfloat16")},
        "ms": hm_times["base"]["kernel_ms"], "kernel_ms": hm_times["base"]["kernel_ms"],
        "plain_ms": hm_times["base"]["plain_ms"], "library_ms": hm_times["base"]["library_ms"],
        "bound_ms": hm_times["base"]["bound_ms"], "bound_by": hm_times["base"]["bound_by"],
        "bytes_ms": hm_times["base"]["bytes_ms"],
        "operations_ms": hm_times["base"]["operations_ms"],
        "shard_4x2_ms": hm_times["shard_4x2"]["kernel_ms"],
        "shard_4x2_plain_ms": hm_times["shard_4x2"]["plain_ms"],
        "shard_4x2_library_ms": hm_times["shard_4x2"]["library_ms"],
        "shard_4x2_bound_ms": hm_times["shard_4x2"]["bound_ms"], **f32_fields("K2"),
    }, gather_entry("gather_kv_rows", "moonshine_tpu/ops/beam_gather.py:30",
                    beam["launches"]["gather_kv_rows"], gather_err, k3,
                    {"bf16_ms": k3_bf16["kernel_ms"], "bf16_plain_ms": k3_bf16["plain_ms"],
                     "bf16_bound_ms": k3_bf16["bound_ms"],
                     "launches_by_path": {"batched beam": beam["launches"]["gather_kv_rows"],
                                          **on_counted_paths("gather_kv_rows")}}),
        gather_entry("gather_scale_rows", "moonshine_tpu/ops/beam_gather.py:76",
                     beam["launches"]["gather_scale_rows"], gather_err, k4,
                     {"launches_by_path": {"batched beam": beam["launches"]["gather_scale_rows"],
                                           **on_counted_paths("gather_scale_rows")}})]
    record = {"card": card, "torch": torch.__version__, "kernels": kernels,
              "kernel_times": times, "hm_times": hm_times, "f32_times": f32_times,
              "batch_independence": batch_independence, "sass": sass,
              "gather_times": gather_times,
              "main_path": main_path, "reference_check": ref, "word_timestamps": words,
              "beam_reference_check": beam_ref, "speculative_reference": spec_ref,
              "batched": batched, "beam": beam, "sharded": sharded,
              "speculative": speculative, "eval": evaluation, "w8a8_main_path": w8a8_main,
              "checkpoint": checkpoint, "w8a8_batched": w8a8_batched, "streaming": streaming,
              "streaming_reference": streaming_ref, "serving": serving,
              "serving_reference": serving_ref, "serving_vad": serving_vad,
              "streaming_bench": streaming_bench, "serving_launches": serving_launches,
              "speakers": speakers, "spelling": spelling, "speaker_launches": speaker_launches,
              "embeddings": embeddings, "agent": agent, "voice_loop": voice,
              "voice_launches": voice_launches, "klatt": klatt,
              "pack_decoder_and_worldlite": pack, "voice_clone": clone, "tok_pos": tok_pos,
              "item12_launches": item12_launches, "item12_s": item12_s,
              "total_s": time.perf_counter() - t_start}
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
