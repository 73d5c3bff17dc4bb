#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moonshine_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 64] [--beam-batch 128]

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch
version on the card (K1 to K5; K1 and K2 also: a batch row alone gives the
bits it gets in a batch, and every bf16 and float32 build of them holds tensor-core
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
the int8-KV ones run K5 (the fused int8-KV decode attention) twice a
decoder layer a decoder call, and ``[serving]`` checks that count against
the ``service.update`` spans. Then speaker identification
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
CPU). Then the edges: ``[native host]`` (libmoonshine_host.so built with
g++ from the port's sources, held against the Python resampler and
segmenter), ``[mic]`` (``mic.MicTranscriber`` over a ``WavSource`` into
``Transcriber(model="base")``, lines against a CPU mic's), ``[server]``
(``TranscriptionServer`` at ``server.main``'s defaults driven without a
socket: slots, update-loop ticks and every RPC, card against CPU),
``[native client]`` (the client library and its selftest), ``[cli and
download]`` (``cli transcribe`` through the catalog against ``--device
cpu``, ``models``, ``g2p``, ``tts``; ``download`` from a loopback
http.server, byte for byte) and ``[latency and fleurs]``; K1 runs in the
mic, cli transcribe and latency paths. Then training and weight tensor
parallelism: ``[train step]`` (Tiny at full width, one AdamW step on 8
synthetic 10 s clips against the CPU's, then 50 steps: step time, audio-s/s,
tokens/s, peak memory, a traced step's idle share and launches),
``[finetune and checkpoint]`` (``finetune`` over a synthetic wav + txt
corpus, the safetensors and train-state round trips, the adapted weights
through ``Transcriber.with_params``), ``[weight TP]`` (``shard_params`` on
the NCCL 1x1 mesh: the sharded train step and ``evaluate(mesh=)`` with
greedy and beam 4 against the unsharded ones, K1, K3 and K4 on the rank's
heads), ``[streaming train]`` (``tiny_streaming``, 4 clips of 4 s, against
the CPU, then 20 steps) and ``[spelling and diarization train]`` (the JAX
defaults on the synthetic voices, first steps against the CPU) and ``[g2p
and tagger train]`` (``distill("en")`` at its defaults, ``train_ja_reader``
and ``train_tok_pos`` on synthetic corpora in the reference's formats, each
step held against the CPU's; the trained models give the same predictions
on the CPU); the trainers launch no kernel of the repository. Every phase that
fails ends the run with a non-zero exit. The last two lines of standard
output are the kernels' JSON summary and the device JSON; a fuller record
goes to chiprun_out/chip_smoke.json. Without CUDA, or without the rest of
the repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import argparse
import asyncio
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


# K5 (ops/int8_kv.attention_dm_q8 on the card) against the plain einsums:
# the relative RMS error over the output and the largest element error over
# the output's largest magnitude (tests/test_torch_int8_attention.py gives
# the reasons: the same rounding places, only the order of float32 sums
# differs).
Q8_TOL = {torch.bfloat16: (2.0**-8, 2.0**-7), torch.float32: (1e-5, 1e-5)}
# (label, B, s, H, hd, T, the cache buffer's columns, mask): the cells'
# decode shapes (Base b64: self cache of 41 columns, 256 memory frames; the
# service: self cache of 448, the 3,200 and 2,048 memory buckets as slices
# of the 3,200-column buffer) and the service's verify at the cell's draft
# cap (128 + 1 rows); Canary-1B-Flash's decode at B=128, 8 heads of 128: self
# attention over a 170-column cache, cross attention over the 513 frames of
# a 40.96 s bucket, each at s=1 and at the 5-token prompt's prefill.
Q8_SHAPES = [
    ("b64 self", 64, 1, 8, 52, 41, 41, "causal"),
    ("b64 cross", 64, 1, 8, 52, 256, 256, "memory"),
    ("serve self", 32, 1, 11, 64, 448, 448, "causal"),
    ("serve cross 3200", 32, 1, 11, 64, 3200, 3200, "memory"),
    ("serve cross 2048", 32, 1, 11, 64, 2048, 3200, "memory"),
    ("verify self", 32, 129, 11, 64, 448, 448, "causal"),
    ("verify cross", 32, 129, 11, 64, 3200, 3200, "memory"),
    ("canary self", 128, 1, 8, 128, 170, 170, "causal"),
    ("canary cross", 128, 1, 8, 128, 513, 513, "memory"),
    ("canary prefill self", 128, 5, 8, 128, 170, 170, "causal"),
    ("canary prefill cross", 128, 5, 8, 128, 513, 513, "memory"),
]


def q8_count() -> int:
    from moonshine_tpu_torch import profiling
    from moonshine_tpu_torch.ops.int8_kv import Q8_LAUNCHES

    return profiling.counter(Q8_LAUNCHES)


def q8_inputs(b, s, h, hd, t, cols, mask_kind, dtype, seed):
    """q and int8 caches quantized from normal values on the card (the
    first T columns of a ``cols``-column buffer), and a bool mask: causal
    over the cache's last s positions [1, 1, s, T], or a memory mask
    [B, 1, 1, T] of lengths from T down to T/2."""
    from moonshine_tpu_torch.ops.int8_kv import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, hd), device="cuda", generator=g).to(dtype)
    caches = []
    for spread in (3.0, 1.0):
        x = torch.randn((b, h, hd, cols), device="cuda", generator=g) * spread
        xq, xs = quantize_kv(x)
        caches += [xq[..., :t], xs[..., :t]]
    key = torch.arange(t, device="cuda")
    if mask_kind == "causal":
        mask = (key[None, :] <= t - s + torch.arange(s, device="cuda")[:, None])[None, None]
    else:
        lengths = t - torch.arange(b, device="cuda") * t // (2 * b)
        mask = (key[None, :] < lengths[:, None])[:, None, None, :]
    kq, ks, vq, vs = caches
    return q, kq, ks, vq, vs, mask


def q8_errors(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        return float("inf"), float("inf")
    return (float((o - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt()),
            float((o - r).abs().max() / r.abs().max()))


def phase_q8_vs_plain(q8) -> float:
    """K5 against the plain version on the same card tensors at every shape
    of Q8_SHAPES, in bf16 and float32, within Q8_TOL; returns the largest
    relative RMS error."""
    worst = 0.0
    for label, b, s, h, hd, t, cols, mask_kind in Q8_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = q8_inputs(b, s, h, hd, t, cols, mask_kind, dtype, seed=b + s + t)
            before = q8_count()
            out = q8.attention_dm_q8(*args)
            torch.cuda.synchronize()
            ref = q8.attention_dm_q8_with_weights(*args)[0]
            rms, elem = q8_errors(out, ref)
            worst = max(worst, rms)
            ok = q8_count() == before + 1 and rms <= Q8_TOL[dtype][0] and elem <= Q8_TOL[dtype][1]
            log(f"  K5 {label} B={b} s={s} H={h} hd={hd} T={t} {str(dtype)[6:]}: relative RMS "
                f"{rms:.3g}, largest {elem:.3g} of max|plain| (limits {Q8_TOL[dtype]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K5 disagrees with its plain version at {label} {dtype}")
    return worst


def q8_bound(args) -> dict:
    """The least time of one K5 call: K and V (int8) and their scales read
    once over the T columns it attends, q and the mask read and out written
    once, against its two products of 2*B*H*s*T*hd operations each at the
    I/O dtype's tensor-core rate (PEAK_FLOPS)."""
    q, kq, ks, _, _, mask = args
    b, s, h, hd = q.shape
    t = kq.shape[3]
    elt = q.element_size()
    bytes_moved = 2 * kq.numel() + 2 * 4 * ks.numel() + 2 * q.numel() * elt + mask.numel()
    flops = 4 * b * h * s * t * hd
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return {"bytes": bytes_moved, "flops": flops, "bytes_ms": t_bytes, "operations_ms": t_flops,
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def phase_q8_times(q8) -> dict:
    """K5, its plain version and the yardstick (SDPA on the bf16 cache
    dequantized beforehand, which the port never calls) at every shape of
    Q8_SHAPES in bf16, beside the bound.  Before each timed call the card
    reads twice its L2 and then spins, as for K3 and K4, so the caches come
    from device memory and the time is the device's alone."""
    from moonshine_tpu_torch.ops.int8_kv import dequantize_kv

    scratch = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device="cuda")

    def before():
        scratch.sum()
        torch.cuda._sleep(2_000_000)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for label, b, s, h, hd, t, cols, mask_kind in Q8_SHAPES:
        dtype = torch.bfloat16
        args = q8_inputs(b, s, h, hd, t, cols, mask_kind, dtype, seed=7)
        q, kq, ks, vq, vs, mask = args
        kernel_ms = cuda_time_ms(lambda: q8.attention_dm_q8(*args), before=before)
        plain_ms = cuda_time_ms(lambda: q8.attention_dm_q8_with_weights(*args)[0], before=before)
        qh = q.transpose(1, 2)
        kd = dequantize_kv(kq, ks, dtype).transpose(2, 3)
        vd = dequantize_kv(vq, vs, dtype).transpose(2, 3)
        library_ms = cuda_time_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask), before=before)
        del kd, vd
        res = {"shape": [b, s, h, hd, t], "buffer_columns": cols, "dtype": "bfloat16",
               "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               **q8_bound(args)}
        log(f"  K5 {label} B={b} s={s} H={h} hd={hd} T={t} bf16: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA on the bf16 cache {library_ms:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {res['bytes'] / 1e6:.1f} MB, "
            f"{res['flops'] / 1e9:.2f} GFLOP) -> {res['bound_ms'] / kernel_ms:.1%} of bound")
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
        launches0 = launch_count(ea.encoder_attention_packed)
        lines, walls = [], []
        for clip in clips:  # the text comes back to the host, so each wall is complete
            t0 = time.perf_counter()
            lines += [line.text or "" for line in tr.transcribe(clip).lines]
            walls.append(time.perf_counter() - t0)
        wall = sum(walls)
        tokens = sum(len(text.split()) for text in lines)  # one word per token here
        launched = launch_count(ea.encoder_attention_packed) - launches0
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


def q8_per_decoder_call(spans, layers: int, what: str) -> float:
    """K5's launches a decoder call over ``spans`` (``greedy.decode`` or
    ``service.update``, their ``q8_launches`` and ``decoder_calls``); each
    span must show two a layer a call (self and cross attention)."""
    calls = sum(sp.attrs["decoder_calls"] for sp in spans)
    launched = sum(sp.attrs["q8_launches"] for sp in spans)
    if not calls or any(sp.attrs["q8_launches"] != 2 * layers * sp.attrs["decoder_calls"]
                        for sp in spans):
        raise SystemExit(f"K5 launched {launched} times over {calls} decoder calls of {what}, "
                         f"not {2 * layers} a call")
    return launched / calls


def phase_batched(ea, cfg, batch: int, card: str, w8a8: bool = False) -> dict:
    """encode + greedy_decode at the bench configuration (batched_workload,
    with w8a8 weights if asked): one warm-up and the best of 3.  K5 must
    launch twice a decoder layer a decoder call, in the recorder's counter
    and in each ``greedy.decode`` span's ``q8_launches``."""
    from moonshine_tpu_torch import profiling

    encode, decode, max_tokens = batched_workload(cfg, batch, w8a8)
    launches_start = launch_count(ea.encoder_attention_packed)
    memory, res, _, _ = run_once(encode, decode)  # warm-up
    check_decode(memory, res, cfg, batch, max_tokens, "batched decode")
    launches0 = launch_count(ea.encoder_attention_packed)
    q8_0 = q8_count()
    walls, encs, decs = [], [], []
    for _ in range(3):
        _, res, enc_s, dec_s = run_once(encode, decode)
        walls.append(enc_s + dec_s)
        encs.append(enc_s)
        decs.append(dec_s)
    per_encode = (launch_count(ea.encoder_attention_packed) - launches0) / 3
    if per_encode != cfg.encoder_layers:
        raise SystemExit(f"K1 launched {per_encode} times per encode, not {cfg.encoder_layers}")
    decodes = profiling.spans("greedy.decode")[-3:]
    q8_per_call = q8_per_decoder_call(decodes, cfg.decoder_layers, "the batched decode")
    if q8_count() - q8_0 != sum(sp.attrs["q8_launches"] for sp in decodes):
        raise SystemExit("K5's counter and the greedy.decode spans' q8_launches disagree")
    best = min(walls)
    seconds = BATCHED_SECONDS
    out = {"batch": batch, "seconds": seconds, "max_tokens": max_tokens,
           "frames": int(memory.shape[1]), "wall_s": walls, "encode_s": encs,
           "decode_s": decs, "audio_s_per_s": batch * seconds / best,
           "mean_tokens": float(res.lengths.float().mean()),
           "k1_launches_per_encode": per_encode,
           "k1_launches": launch_count(ea.encoder_attention_packed) - launches_start, "w8a8": w8a8,
           "q8_launches_per_decoder_call": q8_per_call,
           "decoder_calls": [sp.attrs["decoder_calls"] for sp in decodes],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  B={batch} x {seconds} s (T={out['frames']}), {max_tokens} tokens, bf16, int8 KV"
        f"{', w8a8 weights' if w8a8 else ''}: "
        f"best {best:.4f} s (encode {min(encs):.4f} s, decode {min(decs):.4f} s) -> "
        f"{out['audio_s_per_s']:.2f} audio-s/s on {card}; {per_encode:.0f} K1 launches per "
        f"encode, {q8_per_call:.0f} K5 launches per decoder call; mean tokens "
        f"{out['mean_tokens']:.1f}")
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
        zero_launch_count(c)
    memory, res, _, _ = run_once(encode, decode)  # warm-up
    check_decode(memory, res, cfg, batch, max_tokens, "batched beam")
    torch.cuda.reset_peak_memory_stats()
    before = [launch_count(c) for c in counters]
    walls, encs, decs, all_steps = [], [], [], 0
    for _ in range(3):
        _, res, enc_s, dec_s = run_once(encode, decode)
        walls.append(enc_s + dec_s)
        encs.append(enc_s)
        decs.append(dec_s)
        all_steps += res.steps
    k1, k3, k4 = (launch_count(c) - b for c, b in zip(counters, before))
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
           "launches": {c.__name__: launch_count(c) for c in counters},
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
            zero_launch_count(c)
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
            launches = {c.__name__: launch_count(c) for c in counters}

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
        zero_launch_count(c)
    res = evaluate(model, cfg, BinTokenizer.from_file(tok_path), root, batch_size=16,
                   beam_size=BEAM_SIZE)
    res["launches"] = {c.__name__: launch_count(c)
                       for c in (bg.gather_kv_rows, bg.gather_scale_rows)}
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
    zero_launch_count(ea.encoder_attention_packed)
    lines, walls = [], []
    for clip in clips:
        t0 = time.perf_counter()
        lines += [line.text or "" for line in tr.transcribe(clip).lines]
        walls.append(time.perf_counter() - t0)
    launched = launch_count(ea.encoder_attention_packed)
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
    zero_launch_count(ea.encoder_attention_packed)
    texts = {"catalog": [line.text for line in tr.transcribe(samples).lines],
             "wav": [line.text for line in tr.transcribe_wav(wav).lines]}
    launched = launch_count(ea.encoder_attention_packed)
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


def launch_count(fn) -> int:
    """Launches of one of the port's kernel wrappers so far (the recorder's
    ``launches.<wrapper>`` counter)."""
    from moonshine_tpu_torch import profiling

    return profiling.counter("launches." + fn.__name__)


def zero_launch_count(fn) -> None:
    from moonshine_tpu_torch import profiling

    profiling.reset_counter("launches." + fn.__name__)


def kernel_launches(ea, bg) -> dict:
    """K1-K4's launches by wrapper name, and K5's as ``int8_attention``."""
    counts = {c.__name__: launch_count(c) for c in (ea.encoder_attention_packed,
                                                    ea.encoder_attention, bg.gather_kv_rows,
                                                    bg.gather_scale_rows)}
    return {**counts, "int8_attention": q8_count()}


def reset_launches(ea, bg) -> None:
    from moonshine_tpu_torch import profiling
    from moonshine_tpu_torch.ops.int8_kv import Q8_LAUNCHES

    for c in (ea.encoder_attention_packed, ea.encoder_attention, bg.gather_kv_rows,
              bg.gather_scale_rows):
        zero_launch_count(c)
    profiling.reset_counter(Q8_LAUNCHES)


def phase_serving(card: str) -> dict:
    """The bench's headline configuration on the card: 64 medium_streaming
    streams in 2 cohorts through ShardedStreamingService, bf16, int8 KV,
    SERVING_UPDATES update periods of 0.64 s, each cohort ticked in turn
    after its slots are fed (bench.py's timed loop)."""
    from moonshine_tpu_torch import profiling
    from moonshine_tpu_torch.core.config import STREAMING_ARCHS
    from moonshine_tpu_torch.models import streaming_batch as sb

    S, K = SERVING_STREAMS, SERVING_COHORTS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    svc, feed, warmup_s = serving_workload(S, K)
    setup_s = time.perf_counter() - t_setup
    t_window = time.perf_counter_ns()
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
    updates = [sp for sp in profiling.spans("service.update")
               if sp.start_ns >= t_window and sp.attrs["decode"]]
    q8_per_call = q8_per_decoder_call(updates, STREAMING_ARCHS["medium_streaming"].depth,
                                      "the service's decoding updates")
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
           "state_bytes_per_cohort": reckoned, "state_bytes_allocated": allocated,
           "q8_launches_per_decoder_call": q8_per_call,
           "decoder_calls": [sp.attrs["decoder_calls"] for sp in updates]}
    log(f"  cut: {SERVING_UPDATES} update periods (the bench runs 40); the stagger's pre-fill "
        "drained with ingest-only updates (the bench decodes them)")
    final_p50 = "none" if not final_ms else f"{out['final_ms_p50']:.1f} ms"
    log(f"  medium_streaming, {S} streams in {K} cohorts, bf16, int8 KV, 0.64 s updates: warm-up "
        f"{warmup_s:.2f} s (set-up {setup_s:.2f} s); {out['audio_s_per_s']:.2f} audio-s/s; "
        f"update wall p50 {out['update_ms_p50']:.1f} ms, p95 {out['update_ms_p95']:.1f} ms; "
        f"final-update latency p50 {final_p50}; {len(final_ms)} finals, {events_n} events; "
        f"peak allocated {peak / 1e9:.3f} GB on {card}; {q8_per_call:.0f} K5 launches per "
        f"decoder call over {len(updates)} decoding updates")
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
    # Kernels only: a user annotation's device row (the optimizer's step)
    # spans kernels that have rows of their own.
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "launches": sum(e.count for e in rows),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top]}


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
    launches0 = launch_count(ea.encoder_attention_packed)
    t0 = time.perf_counter()
    res = ti.evaluate(tts.synthesize, transcribe)
    for _, hyp, _ in res.per_sentence:
        agent.handle_utterance(hyp)
    for sentence in ti.DEFAULT_SENTENCES:
        agent.handle_utterance(sentence)
    tts.wait()
    loop_s = time.perf_counter() - t0
    tts.stop()
    k1 = launch_count(ea.encoder_attention_packed) - launches0
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
# The sampled mel (values up to about 6), card against CPU.  The CPU tests
# hold the port to 2e-5 of JAX on one CPU.  On the card (an H100, PERF.md
# §6) the gap is one velocity evaluation's float32 rounding (cuBLAS's
# products and the 1,024-key attention sums in another order than the
# CPU's), read through the mel's 1 / feat_scale = 10 and guidance's
# scaling of the branches' difference; it does not grow over the Euler
# steps: 4.196e-5 at guidance 3.0 and 8 steps, 1.907e-5 at guidance 1.0,
# 6.485e-5 after one step at guidance 3.0 and 2.146e-5 after one at 1.0.
# One step at guidance 1.0 already exceeds 2e-5, so the card is held to
# 2e-4, about 3x the one-step reading at guidance 3.0.
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
    launches0 = launch_count(ea.encoder_attention_packed)
    t0 = time.perf_counter()
    words = [w for line in tr.transcribe(speech).lines for w in line.words]
    asr_s = time.perf_counter() - t0
    k1 = launch_count(ea.encoder_attention_packed) - launches0
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
    # CLONE_MEL_TOL's stated cause, tested: the card-cpu gap of the sampled
    # mel with guidance 1.0 (no scaling of the branches' difference), after
    # one Euler step, and both.
    mel_gaps = {}
    for label, guidance, steps in (("guidance 1.0", 1.0, cloner.num_steps),
                                   ("1 Euler step", cloner.guidance, 1),
                                   ("guidance 1.0, 1 step", 1.0, 1)):
        saved = [(c, c.guidance, c.num_steps) for c in (cloner, cpu)]
        for c in (cloner, cpu):
            c.guidance, c.num_steps = guidance, steps
        got, _, _ = cloner.mel_from_ipa(ipa, x0=x0)
        ref, _, _ = cpu.mel_from_ipa(ipa, x0=x0)
        mel_gaps[label] = float((got.cpu() - ref).abs().max())
        for c, g, n in saved:
            c.guidance, c.num_steps = g, n
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
    log(f"  sampled mel, card against cpu, at guidance {cloner.guidance:g} and "
        f"{cloner.num_steps} steps {mel_err:.3e}; " + ", ".join(
            f"{k} {v:.3e}" for k, v in mel_gaps.items()))
    if not k1:
        raise SystemExit("K1 did not launch in the clone session's transcription")
    if (not prompt_ok or mel_err > CLONE_MEL_TOL or wav_err > CLONE_WAV_TOL or not onnx_ok
            or not np.isfinite(out).all() or len(out) == 0):
        raise SystemExit("the voice cloner on the card disagrees with the CPU's")
    return {"k1_launches": k1, "words": len(words), "asr_s": asr_s,
            "clip_s": clip.audio.size / SAMPLE_RATE, "prompt_mel_max_abs_err": prompt_err,
            "mel_max_abs_err": mel_err, "mel_gaps": mel_gaps, "wav_max_abs_err": wav_err,
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


# -- the edges: native host, mic, server, native client, CLI, harnesses ------

EDGE_MIC_SECONDS = 20.0
EDGE_SERVER_SLOTS = 4  # slots driven, of server.main's 16
EDGE_SERVER_SECONDS = 3.0
EDGE_SERVER_TICKS = 10  # 3 s at 0.64 s an update, then the finals and the flush
EDGE_LIVE_PAUSE = 0.05  # s between a live stream's 0.25 s chunks (5x real time)
EDGE_G2P_TEXTS = ("hello world", "read the 2nd chapter")
EDGE_EMBED_TEXTS = ("order a drink", "take the survey", "yes")
RESAMPLE_TOL = 1e-5  # the native resampler against the Python one (tests/test_native_host.py)
SEGMENT_TOL = 1e-6  # native segment times (s) and audio against the Python segmenter


def _oracle_probs(probs):
    """A hop-probability function that replays ``probs`` (then 0)."""
    it = iter(list(probs))
    return lambda hops: np.asarray([next(it, 0.0) for _ in range(hops.shape[0])], np.float32)


def phase_native_host(card: str) -> dict:
    """``runtime/native_host``: libmoonshine_host.so built from the port's
    copy with g++ (a failed build ends the run: no fallback here), then
    ``native_resample``, ``NativeRing`` (wraparound and overflow) and
    ``NativeSegmenter`` against the port's Python resampler and
    ``VadSegmenter``, as tests/test_native_host.py holds them."""
    from moonshine_tpu_torch.audio.resample import resample_audio
    from moonshine_tpu_torch.pipeline.vad_segmenter import VadSegmenter
    from moonshine_tpu_torch.runtime import native_host as nh

    t0 = time.perf_counter()
    path = nh.build_native(force=True)
    build_s = time.perf_counter() - t0
    lib = nh.load(auto_build=False) if path is not None else None
    if lib is None:
        raise SystemExit("libmoonshine_host.so did not build from the port's sources")
    rng = np.random.default_rng(0)
    resample_err = 0.0
    for in_rate, out_rate in ((44100, 16000), (8000, 16000), (16000, 16000), (48000, 16000)):
        audio = rng.standard_normal(in_rate // 7).astype(np.float32)
        ours, ref = nh.native_resample(audio, in_rate, out_rate), resample_audio(audio, in_rate,
                                                                                 out_rate)
        if ours.shape != ref.shape:
            raise SystemExit(f"native_resample {in_rate}->{out_rate} gave {ours.shape}, "
                             f"the Python path {ref.shape}")
        resample_err = max(resample_err, float(np.abs(ours - ref).max()))
    ring = nh.NativeRing(100)
    a, b = np.arange(80, dtype=np.float32), np.arange(100, 170, dtype=np.float32)
    ring_ok = (ring.capacity == 100 and ring.write(a) == 80
               and np.array_equal(ring.read(50), a[:50]) and ring.write(b) == 70
               and np.array_equal(ring.read(200), np.concatenate([a[50:], b]))
               and ring.write(np.ones(200, np.float32)) == 100 and ring.available == 100)
    hop = 512
    cases = [([0.0, 0.9, 0.9, 0.9, 0.9, 0.0, 0.0], {}),
             ([0.9] * 5, {"max_segment_sample_count": 0}),
             ([1.0] * 40, {"max_segment_sample_count": 10 * hop}),
             ([1.0] * 40, {"max_segment_sample_count": 10 * hop, "threshold": 0.0}),
             ([0.0, 0.9, 0.9, 0.0] * 3, {})]
    segments, seg_ok = 0, True
    for probs, kw in cases:
        audio = rng.standard_normal(len(probs) * hop).astype(np.float32) * 0.1
        py = VadSegmenter(_oracle_probs(probs), window_size=1, **kw)
        nat = nh.NativeSegmenter(_oracle_probs(probs), window_size=1, **kw)
        for s in (py, nat):
            s.start()
            s.process_audio(audio)
            s.stop()
        ps, ns = py.segments, nat.segments
        segments += len(ns)
        seg_ok &= len(ps) == len(ns) and all(
            p.is_complete == n.is_complete and abs(p.start_time - n.start_time) <= SEGMENT_TOL
            and abs(p.end_time - n.end_time) <= SEGMENT_TOL
            and p.audio_data.shape == n.audio_data.shape
            and np.allclose(p.audio_data, n.audio_data, atol=SEGMENT_TOL, rtol=0)
            for p, n in zip(ps, ns))
        seg_ok &= (py.retained_segment_audio_byte_count() == nat.retained_segment_audio_byte_count()
                   and py.completed_segment_audio_byte_count()
                   == nat.completed_segment_audio_byte_count())
    log(f"  {path.name} {lib.mt_host_version().decode()} built with g++ in {build_s:.2f} s; "
        f"native_resample against the Python path max_abs_err {resample_err:.3e} (tolerance "
        f"{RESAMPLE_TOL:g}); NativeRing wraparound and overflow {ring_ok}; NativeSegmenter "
        f"{len(cases)} cases, {segments} segments equal to VadSegmenter's {seg_ok} (host code, "
        f"on the card's host: {card})")
    if resample_err > RESAMPLE_TOL or not ring_ok or not seg_ok:
        raise SystemExit("the native host runtime disagrees with the port's Python paths")
    return {"build_s": build_s, "resample_max_abs_err": resample_err, "ring_ok": ring_ok,
            "segmenter_cases": len(cases), "segments": segments}


def _line_rows(transcript) -> list:
    return [(line.text, line.start_time, line.duration, line.is_complete)
            for line in transcript.lines]


def phase_mic(tokenizer_path: str, root: str, card: str) -> dict:
    """``mic.MicTranscriber().use_transcriber(Transcriber(model="base"))`` on
    the card (the VAD off: a random-weight VAD hears no speech in synthetic
    speech) over a ``WavSource(pace=False)`` of EDGE_MIC_SECONDS of
    ``two_speaker_conversation``, through the native ring; then the same
    audio through a CPU ``Transcriber`` with the same weights, behind the
    same kind of mic.  Lines and text must be equal; each line's final
    text comes from its completed segment (the partial passes follow the
    host's clock)."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.audio.wav import save_wav
    from moonshine_tpu_torch.mic import MicTranscriber, WavSource
    from moonshine_tpu_torch.runtime.native_host import NativeRing

    audio, _ = two_speaker_conversation(EDGE_MIC_SECONDS, seed=4)
    path = os.path.join(root, "mic.wav")
    save_wav(path, audio, SAMPLE_RATE)
    card_tr = Transcriber(model="base", tokenizer_path=tokenizer_path).with_options(
        vad_threshold=0).load()
    cpu_tr = Transcriber(model="base", tokenizer_path=tokenizer_path, device="cpu").with_params(
        copy.deepcopy(card_tr.model).to("cpu")).with_options(vad_threshold=0).load()
    if card_tr.device.type != "cuda":
        raise SystemExit("the mic's Transcriber is not on cuda")
    runs = {}
    for name, tr in (("cuda", card_tr), ("cpu", cpu_tr)):
        texts = []
        mic = MicTranscriber().use_transcriber(tr).audio_source(
            WavSource(path, pace=False)).on_text(texts.append).load()
        t0 = time.perf_counter()
        mic.start()
        mic._thread.join(timeout=300.0)
        if mic._thread.is_alive():
            raise SystemExit(f"the {name} mic's capture thread did not drain its source")
        ring = mic._ring
        transcript = mic.stop()
        runs[name] = {"wall_s": time.perf_counter() - t0, "lines": _line_rows(transcript),
                      "text": transcript.text, "events": len(texts),
                      "native_ring": isinstance(ring, NativeRing)}
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    same = card_run["lines"] == cpu_run["lines"] and card_run["text"] == cpu_run["text"]
    log(f"  {EDGE_MIC_SECONDS:g} s through MicTranscriber: card wall {card_run['wall_s']:.3f} s "
        f"({len(card_run['lines'])} lines, {card_run['events']} text events, native ring "
        f"{card_run['native_ring']}); cpu wall {cpu_run['wall_s']:.3f} s; lines and text equal "
        f"{same}; first line {card_run['lines'][0][0][:50] if card_run['lines'] else None!r} "
        f"on {card}")
    if not card_run["native_ring"]:
        raise SystemExit("the mic's ring is not the native ring")
    if not same or not card_run["lines"] or not all(row[3] for row in card_run["lines"]):
        raise SystemExit("the mic on the card does not transcribe as the cpu's")
    return {"wall_s": card_run["wall_s"], "cpu_wall_s": cpu_run["wall_s"],
            "lines": len(card_run["lines"]), "text_events": card_run["events"]}


class FakeSocket:
    """A stand-in for a WebSocket connection: ``recv`` and ``async for``
    give ``incoming`` in order (``async for`` waits ``pause`` s before each
    message), ``send`` keeps what the server sends."""

    def __init__(self, incoming=(), pause: float = 0.0):
        self.incoming, self.sent, self.closed = list(incoming), [], False
        self.pause = pause

    async def send(self, message) -> None:
        self.sent.append(message)

    async def recv(self):
        return self.incoming.pop(0)

    def __aiter__(self):
        return self

    async def __anext__(self):
        if not self.incoming:
            raise StopAsyncIteration
        await asyncio.sleep(self.pause)
        return self.incoming.pop(0)

    async def close(self) -> None:
        self.closed = True


def _energy_hop_prob(hops: np.ndarray) -> np.ndarray:
    """tests/test_native_client.py's speech-clip VAD: voiced where a hop
    has energy."""
    return (np.abs(hops).mean(axis=1) > 0.05).astype(np.float32)


def drive_server(device: str, embedder) -> dict:
    """``server.make_server`` (server.main's defaults: tiny_streaming, 16
    streams, seeded weights) on ``device``, driven without a socket:
    ``_acquire_slot`` for EDGE_SERVER_SLOTS streams, their audio and stop
    as ``_handle_stream`` applies them, then EDGE_SERVER_TICKS ticks of
    ``_update_loop`` on its own thread (no sleep between them), its
    payloads collected by an event loop; then one ``_handle_rpc`` of each
    kind through a FakeSocket."""
    import threading

    from moonshine_tpu_torch import server as srv

    server = srv.make_server(["--device", device, "--tick", "0"])
    server._vad_hop_prob_fn = _energy_hop_prob
    server._embedder = embedder
    loop = asyncio.new_event_loop()
    server._loop = loop
    slots = [server._acquire_slot() for _ in range(EDGE_SERVER_SLOTS)]
    for i, slot in enumerate(slots):
        audio, _ = two_speaker_conversation(EDGE_SERVER_SECONDS, seed=20 + i)
        conn = srv._Conn(slot=slot, sample_rate=SAMPLE_RATE, queue=asyncio.Queue())
        server._conns[slot] = conn
        server.service.add_audio(slot, audio)
        server.service.close_slot(slot)
        conn.stopping = True
    real_update, walls = server.service.update, []

    def counted_update(*args, **kw):
        t0 = time.perf_counter()
        events = real_update(*args, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == EDGE_SERVER_TICKS:
            server._running = False
        return events

    server.service.update = counted_update
    server._running = True
    thread = threading.Thread(target=server._update_loop, daemon=True)
    thread.start()
    thread.join(timeout=300.0)
    if thread.is_alive():
        raise SystemExit("the server's update loop did not stop")
    loop.run_until_complete(asyncio.sleep(0))  # run the queued put_nowait callbacks
    payloads = {}
    for slot in slots:
        q, got = server._conns[slot].queue, []
        while not q.empty():
            got.append({k: v for k, v in q.get_nowait().items() if k != "latency_ms"})
        payloads[slot] = got
    loop.close()

    clip = np.zeros(8 * SAMPLE_RATE, np.float32)
    clip[2 * SAMPLE_RATE:7 * SAMPLE_RATE] = synthetic_clip(5.0, 30) * 2.0
    requests = [("tts", {"type": "tts", "text": "hello world"}, []),
                ("g2p", {"type": "g2p", "text": EDGE_G2P_TEXTS[0]}, []),
                ("g2p 2", {"type": "g2p", "text": EDGE_G2P_TEXTS[1]}, []),
                ("embed", {"type": "embed", "texts": list(EDGE_EMBED_TEXTS)}, []),
                ("speech_clip", {"type": "speech_clip", "sample_rate": SAMPLE_RATE},
                 [clip.tobytes(), json.dumps({"type": "end"})]),
                ("catalog", {"type": "catalog", "kind": "stt_catalog"}, [])]
    rpc, rpc_ms = {}, {}
    for name, msg, incoming in requests:
        sock = FakeSocket(incoming)
        t0 = time.perf_counter()
        asyncio.run(server._handle_rpc(sock, msg))
        rpc_ms[name] = (time.perf_counter() - t0) * 1e3
        if not sock.closed or not sock.sent:
            raise SystemExit(f"the {name} RPC did not answer and close")
        # The catalog's document rides a binary frame as UTF-8 JSON; TTS
        # audio and embeddings ride theirs as little-endian float32.
        rpc[name] = [json.loads(m) if isinstance(m, str)
                     else json.loads(m.decode()) if name == "catalog"
                     else np.frombuffer(m, "<f4") for m in sock.sent]
    return {"payloads": payloads, "rpc": rpc, "rpc_ms": rpc_ms, "tick_ms": [w * 1e3 for w in walls],
            "device": str(server.device), "streams": server.service.S}


def drive_server_live(device: str) -> dict:
    """``server.make_server`` on ``device`` as it serves: its device loop
    ticks on its own thread (0.02 s a tick) while EDGE_SERVER_SLOTS streams
    arrive through ``_handle_stream`` on the event loop's thread, each a
    FakeSocket that hands over 0.25 s of audio every EDGE_LIVE_PAUSE s and
    then stops.  Which update saw which audio follows the clock, so the
    texts are not compared: each stream must end on one ``stopped`` after
    at least one final, with its final segment ids in order, and every
    slot must come back free."""
    import threading

    from moonshine_tpu_torch import server as srv

    server = srv.make_server(["--device", device, "--tick", "0.02"])
    quarter = SAMPLE_RATE // 4
    socks = []
    for i in range(EDGE_SERVER_SLOTS):
        audio, _ = two_speaker_conversation(EDGE_SERVER_SECONDS, seed=20 + i)
        chunks = [audio[k:k + quarter].tobytes() for k in range(0, len(audio), quarter)]
        socks.append(FakeSocket([json.dumps({"type": "start", "sample_rate": SAMPLE_RATE})]
                                + chunks + [json.dumps({"type": "stop"})],
                                pause=EDGE_LIVE_PAUSE))

    async def run() -> None:
        server._loop = asyncio.get_running_loop()
        server._running = True
        thread = threading.Thread(target=server._update_loop, daemon=True)
        thread.start()
        try:
            await asyncio.wait_for(asyncio.gather(
                *(server._handle_stream(sock, sock.incoming.pop(0)) for sock in socks)),
                timeout=120.0)
        finally:
            server._running = False
            await asyncio.to_thread(thread.join, 30.0)
        if thread.is_alive():
            raise SystemExit("the live server's update loop did not stop")

    t0 = time.perf_counter()
    asyncio.run(run())
    wall = time.perf_counter() - t0
    streams = [[json.loads(m) for m in sock.sent] for sock in socks]
    ok = all(
        ps and ps[-1]["type"] == "stopped" and [p["type"] for p in ps].count("stopped") == 1
        and any(p["type"] == "final" for p in ps)
        and [p["segment"] for p in ps if p["type"] == "final"]
        == sorted(p["segment"] for p in ps if p["type"] == "final")
        for ps in streams)
    freed = not server._conns and sorted(server._free) == list(range(server.service.S))
    return {"wall_s": wall, "ok": ok, "freed": freed,
            "kinds": [p["type"] for ps in streams for p in ps]}


def phase_server(card_emb, cpu_emb, card: str) -> dict:
    """``TranscriptionServer`` over ``StreamingService`` at tiny_streaming's
    full width with server.main's 16 streams, driven without a socket
    (``drive_server``) on the card and on the CPU: the stream payloads
    (all but ``latency_ms``) must be equal; the RPCs' JSON headers equal,
    TTS audio within WAVEFORM_TOL and embeddings within EMBED_TOL (the
    [tts and voice loop] and [embeddings] bounds; ``embed`` runs the
    [embeddings] phase's EmbeddingGemma on each device), G2P, speech-clip
    bounds and the catalog equal.  ``websockets`` is not needed: the
    socket is a stand-in."""
    card_run = drive_server("cuda", card_emb)
    cpu_run = drive_server("cpu", cpu_emb)
    live = drive_server_live("cuda")
    if card_run["device"].split(":")[0] != "cuda":
        raise SystemExit("the server's service is not on cuda")
    payloads_equal = card_run["payloads"] == cpu_run["payloads"]
    kinds = [p["type"] for ps in card_run["payloads"].values() for p in ps]
    flushed = all(ps and ps[-1]["type"] == "stopped" and any(p["type"] == "final" for p in ps)
                  for ps in card_run["payloads"].values())
    errs, rpc_ok = {}, True
    for name, card_msgs in card_run["rpc"].items():
        cpu_msgs = cpu_run["rpc"][name]
        rpc_ok &= len(card_msgs) == len(cpu_msgs) and card_msgs[0].get("type") != "error"
        for a, b in zip(card_msgs, cpu_msgs):
            if not isinstance(a, np.ndarray):
                rpc_ok &= a == b
            else:
                errs[name] = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    rpc_ok &= errs.get("tts", np.inf) <= WAVEFORM_TOL and errs.get("embed", np.inf) <= EMBED_TOL
    clip = card_run["rpc"]["speech_clip"][0]
    ticks = card_run["tick_ms"]
    log(f"  server.make_server() on {card_run['device']}: {card_run['streams']} streams, "
        f"{EDGE_SERVER_SLOTS} driven with {EDGE_SERVER_SECONDS:g} s each; {len(ticks)} ticks of "
        f"_update_loop, tick ms median {statistics.median(ticks):.3f} (first {ticks[0]:.3f}, max "
        f"{max(ticks):.3f}); {kinds.count('partial')} partial, {kinds.count('final')} final, "
        f"{kinds.count('stopped')} stopped payloads; card against cpu payloads equal "
        f"{payloads_equal} on {card}")
    log("  RPC ms on the card (cpu): " + ", ".join(
        f"{k} {v:.2f} ({cpu_run['rpc_ms'][k]:.2f})" for k, v in card_run["rpc_ms"].items())
        + f"; card against cpu: tts {errs.get('tts', np.nan):.3e} (tolerance "
        f"{WAVEFORM_TOL:g}), embed {errs.get('embed', np.nan):.3e} (tolerance {EMBED_TOL:g}), "
        f"headers, IPA, clip and catalog equal {rpc_ok}; clip {clip}")
    live_kinds = live["kinds"]
    log(f"  live: {EDGE_SERVER_SLOTS} streams through _handle_stream while _update_loop ticks, "
        f"{len(live_kinds)} payloads ({live_kinds.count('partial')} partial, "
        f"{live_kinds.count('final')} final, {live_kinds.count('stopped')} stopped) in "
        f"{live['wall_s']:.3f} s; each ends on stopped after a final, finals in order "
        f"{live['ok']}; every slot free {live['freed']} on {card}")
    if not payloads_equal or not flushed:
        raise SystemExit("the server's stream payloads on the card differ from the cpu's")
    if not live["ok"] or not live["freed"]:
        raise SystemExit("the live server broke its stream protocol on the card")
    if not rpc_ok or not clip.get("found"):
        raise SystemExit("the server's RPCs on the card disagree with the cpu's")
    return {"tick_ms": ticks, "cpu_tick_ms": cpu_run["tick_ms"], "rpc_ms": card_run["rpc_ms"],
            "cpu_rpc_ms": cpu_run["rpc_ms"], "rpc_max_abs_err": errs,
            "live_wall_s": live["wall_s"],
            "payloads": {k: len(v) for k, v in card_run["payloads"].items()}}


def phase_native_client(card: str) -> dict:
    """``runtime/native_client``: libmoonshine_client.so and client_selftest
    built from the port's copy with g++ (a failed build ends the run), the
    selftest run (SHA-1, base64, JSON, the RFC 6455 frame codec).  The
    loopback needs ``websockets`` on the server side, which this machine's
    packages may lack, so it runs in the CPU tests only
    (tests/test_torch_native_client.py)."""
    from moonshine_tpu_torch.runtime import native_client as nc

    t0 = time.perf_counter()
    lib_path, exe = nc.build_native(force=True), nc.build_selftest(force=True)
    build_s = time.perf_counter() - t0
    if lib_path is None or exe is None or nc.load(auto_build=False) is None:
        raise SystemExit("the native client did not build from the port's sources")
    t0 = time.perf_counter()
    out = subprocess.run([str(exe), "500"], capture_output=True, text=True, timeout=300)
    run_s = time.perf_counter() - t0
    ok = out.returncode == 0 and "client_selftest OK" in out.stdout
    log(f"  {lib_path.name} {nc.load().mt_client_version().decode()} and client_selftest built "
        f"with g++ in {build_s:.2f} s; selftest {out.stdout.strip()!r} in {run_s:.2f} s; the "
        f"WebSocket loopback runs in the CPU tests only (the server side needs websockets); "
        f"on {card}")
    if not ok:
        raise SystemExit(f"client_selftest failed: {out.stdout[-500:]} {out.stderr[-500:]}")
    return {"build_s": build_s, "selftest_s": run_s}


def run_cli(argv) -> tuple[int, str, str]:
    """``cli.main(argv)`` with its standard output and error captured."""
    import contextlib
    import io

    from moonshine_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def phase_cli_and_download(ea, catalog_root: str, root: str, card: str) -> dict:
    """The CLI on the card: ``transcribe`` with Base through the cache that
    [checkpoint and catalog] wrote (MOONSHINE_TPU_CACHE), the VAD off,
    against ``--device cpu`` (the same lines); ``models --json`` (the
    catalog), ``g2p`` and ``tts --voice klatt``.  Then ``download base``
    from a local http.server that serves that cache on 127.0.0.1 (nothing
    leaves the host) into a second cache: the files byte for byte.  K1's
    launches are counted over the card's transcribe alone."""
    import http.server
    import threading
    from functools import partial

    from moonshine_tpu_torch import catalog
    from moonshine_tpu_torch.audio.wav import load_wav, save_wav
    from moonshine_tpu_torch.tts.g2p import GraphemeToPhonemizer

    wav = os.path.join(root, "cli.wav")
    save_wav(wav, synthetic_clip(BATCHED_SECONDS, 12), SAMPLE_RATE)
    old = os.environ.get("MOONSHINE_TPU_CACHE")
    os.environ["MOONSHINE_TPU_CACHE"] = catalog_root
    try:
        argv = ["transcribe", wav, "--model", "base", "--vad-threshold", "0"]
        zero_launch_count(ea.encoder_attention_packed)
        t0 = time.perf_counter()
        rc, out, err = run_cli(argv)
        transcribe_s = time.perf_counter() - t0
        k1 = launch_count(ea.encoder_attention_packed)
        rc_cpu, out_cpu, _ = run_cli(argv + ["--device", "cpu"])
    finally:
        if old is None:
            del os.environ["MOONSHINE_TPU_CACHE"]
        else:
            os.environ["MOONSHINE_TPU_CACHE"] = old
    transcribe_ok = rc == rc_cpu == 0 and out == out_cpu and out.startswith("[")
    rc_models, models, _ = run_cli(["models", "--json"])
    models_ok = rc_models == 0 and json.loads(models) == json.loads(catalog.catalog_json())
    rc_g2p, ipa, _ = run_cli(["g2p", EDGE_G2P_TEXTS[0]])
    g2p_ok = rc_g2p == 0 and ipa.strip() == GraphemeToPhonemizer("en").text_to_ipa(
        EDGE_G2P_TEXTS[0]) != ""
    klatt_wav = os.path.join(root, "klatt.wav")
    t0 = time.perf_counter()
    rc_tts, tts_out, _ = run_cli(["tts", "seven", "--voice", "klatt", "-o", klatt_wav])
    tts_s = time.perf_counter() - t0
    audio, sr = load_wav(klatt_wav) if rc_tts == 0 else (np.zeros(0), 0)
    tts_ok = rc_tts == 0 and sr == 22050 and audio.size > 0 and np.isfinite(audio).all()

    handler = partial(http.server.SimpleHTTPRequestHandler, directory=catalog_root)
    handler.log_message = lambda *a: None
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    serve = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve.start()
    dest_root = os.path.join(root, "downloaded")
    old = os.environ.get("MOONSHINE_TPU_CACHE")
    os.environ["MOONSHINE_TPU_CACHE"] = dest_root
    try:
        t0 = time.perf_counter()
        rc_dl, dl_out, dl_err = run_cli(["download", "base", "--base-url",
                                         f"http://127.0.0.1:{httpd.server_port}"])
        download_s = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve.join(timeout=30.0)
        if old is None:
            del os.environ["MOONSHINE_TPU_CACHE"]
        else:
            os.environ["MOONSHINE_TPU_CACHE"] = old
    files, same_bytes = ("model.safetensors", "tokenizer.bin"), True
    for name in files:
        with open(os.path.join(catalog_root, "base-en", name), "rb") as f:
            src = f.read()
        got = os.path.join(dest_root, "base-en", name)
        same_bytes &= os.path.exists(got) and open(got, "rb").read() == src
    size = os.path.getsize(os.path.join(catalog_root, "base-en", "model.safetensors"))
    log(f"  cli transcribe (Base from the catalog) on cuda in {transcribe_s:.3f} s, "
        f"{out.count(chr(10))} lines, K1 {k1} launches, equal to --device cpu {transcribe_ok}; "
        f"models --json is the catalog {models_ok}; g2p {ipa.strip()!r} {g2p_ok}; tts --voice "
        f"klatt {audio.size} samples at {sr} Hz in {tts_s:.3f} s ({tts_out.strip()!r})")
    log(f"  cli download base from 127.0.0.1 into a fresh cache: rc {rc_dl}, {len(files)} files "
        f"({size / 1e6:.1f} MB checkpoint) in {download_s:.3f} s, byte for byte {same_bytes}; "
        f"on {card}")
    if not transcribe_ok or not k1:
        raise SystemExit(f"cli transcribe on the card failed or differs from the cpu's: {err}")
    if not (models_ok and g2p_ok and tts_ok):
        raise SystemExit("cli models, g2p or tts failed")
    if rc_dl != 0 or not same_bytes:
        raise SystemExit(f"cli download failed: {dl_out} {dl_err}")
    return {"transcribe_s": transcribe_s, "k1_launches": k1, "tts_s": tts_s,
            "download_s": download_s, "download_bytes": size}


def phase_latency_and_fleurs(tokenizer_path: str, root: str, card: str) -> dict:
    """``eval/latency.run_latency_bench`` over ``Transcriber(model="base")``
    on the card (the VAD off, 21 ms chunks, 0.5 s updates) on 10 s of
    ``two_speaker_conversation``: compute as % of audio and the average
    post-phrase latency.  Then ``eval/fleurs.evaluate_languages`` with the
    same Base model over a synthetic corpus of two languages, ``ja`` (CER)
    and ``en`` (WER), three wav + txt pairs each.  Both run again on a CPU
    ``Transcriber`` with the same weights: the transcript text, the number
    of completed lines, each language's hypotheses and its table (all but
    the timings) must be equal.  A line's final text comes from its
    completed segment alone, so the host's clock does not enter them."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.audio.wav import save_wav
    from moonshine_tpu_torch.core.config import BASE
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.eval import fleurs
    from moonshine_tpu_torch.eval.latency import run_latency_bench

    audio, _ = two_speaker_conversation(10.0, seed=6)
    wav = os.path.join(root, "latency.wav")
    save_wav(wav, audio, SAMPLE_RATE)
    opts = dict(vad_threshold=0, vad_max_segment_duration=4.0)
    tr = Transcriber(model="base", tokenizer_path=tokenizer_path).with_options(**opts).load()
    cpu_tr = Transcriber(model="base", tokenizer_path=tokenizer_path, device="cpu").with_params(
        copy.deepcopy(tr.model).to("cpu")).with_options(**opts).load()
    if tr.device.type != "cuda":
        raise SystemExit("the latency bench's Transcriber is not on cuda")
    lat = run_latency_bench(tr, wav, update_interval=0.5)
    cpu_lat = run_latency_bench(cpu_tr, wav, update_interval=0.5)
    lat_same = lat["text"] == cpu_lat["text"] and lat["completed_lines"] == cpu_lat["completed_lines"]

    corpus = os.path.join(root, "fleurs")
    texts = {"ja": ("数学の本", "東京に行きます", "良い天気"), "en": ("W3 W4", "SOME WORDS", "W7")}
    for lang, lines in texts.items():
        os.makedirs(os.path.join(corpus, lang))
        for i, text in enumerate(lines):
            save_wav(os.path.join(corpus, lang, f"u{i}.wav"), synthetic_clip(2.0 + i, 40 + i),
                     SAMPLE_RATE)
            with open(os.path.join(corpus, lang, f"u{i}.txt"), "w") as f:
                f.write(text + "\n")
    tok = BinTokenizer.from_file(tokenizer_path)
    # evaluate_languages pops each language's hypotheses from its table:
    # keep them from the evaluate calls it makes.
    real_evaluate, hyps = fleurs.evaluate, []

    def recording_evaluate(*args, **kw):
        out = real_evaluate(*args, **kw)
        hyps[-1].append(list(out["hyps"]))
        return out

    tables, fleurs_s = {}, {}
    fleurs.evaluate = recording_evaluate
    try:
        for name, model in (("cuda", tr.model), ("cpu", cpu_tr.model)):
            hyps.append([])
            t0 = time.perf_counter()
            tables[name] = fleurs.evaluate_languages(lambda lang: (model, BASE, tok), corpus,
                                                     batch_size=4)
            fleurs_s[name] = time.perf_counter() - t0
    finally:
        fleurs.evaluate = real_evaluate
    table = tables["cuda"]
    scored = ("metric", "cer", "wer", "errors", "words", "utterances", "audio_seconds")
    fleurs_same = hyps[0] == hyps[1] and all(
        table[lang].get(k) == tables["cpu"].get(lang, {}).get(k) for lang in table for k in scored)
    log(f"  latency bench, {lat['audio_seconds']:.2f} s on cuda: compute {lat['compute_percent_of_audio']:.2f} % "
        f"of audio, average post-phrase latency {lat['avg_post_phrase_latency_ms']:.3f} ms over "
        f"{lat['completed_lines']} lines, wall {lat['wall_seconds']:.3f} s (cpu: "
        f"{cpu_lat['compute_percent_of_audio']:.2f} %, {cpu_lat['wall_seconds']:.3f} s); text and "
        f"lines equal to the cpu's {lat_same}; fleurs {fleurs_s['cuda']:.3f} s (cpu "
        f"{fleurs_s['cpu']:.3f} s): "
        + ", ".join(f"{k} {v['metric']} {v.get(v['metric'], v.get('wer')):.3f} over "
                    f"{v['utterances']} utterances" for k, v in table.items())
        + f"; hypotheses and tables equal to the cpu's {fleurs_same} on {card}")
    if lat["completed_lines"] < 2 or not np.isfinite(lat["avg_post_phrase_latency_ms"]):
        raise SystemExit("the latency bench completed too few lines")
    if not lat_same or not lat["text"].strip():
        raise SystemExit("the latency bench on the card does not transcribe as the cpu's")
    if set(table) != {"ja", "en"} or table["ja"]["metric"] != "cer" \
            or table["en"]["metric"] != "wer" or not np.isfinite(table["ja"]["cer"]):
        raise SystemExit(f"evaluate_languages gave {table}")
    if not fleurs_same or not any(h for per_lang in hyps[0] for h in per_lang):
        raise SystemExit("evaluate_languages on the card does not decode as the cpu's")
    return {"latency": {k: v for k, v in lat.items() if k != "text"},
            "cpu_latency": {k: v for k, v in cpu_lat.items() if k != "text"}, "fleurs": table,
            "fleurs_s": fleurs_s["cuda"], "cpu_fleurs_s": fleurs_s["cpu"]}


TRAIN_BATCH = 8  # clips of the Tiny train step
TRAIN_SECONDS = 10.0
TRAIN_TOKENS = 40
TRAIN_LR = 1e-3
TRAIN_STEPS = 50
# Predicted in PERF.md before the first run on the card: the loss of the 50th
# step at most this fraction of the first's (reported, not a gate).
TRAIN_PREDICTED_RATIO = 0.5
# Card against CPU, one AdamW step from the same weights: the loss to
# rtol 1e-4 and each gradient leaf within 1e-3 of its largest |g|
# (float32 sums over up to 8 x 416 frames in another order).  The updated
# parameters are not held to the CPU's step: Adam's first update
# lr * m / (sqrt(v) + eps) can give an element whose gradient is near zero
# a full step of either sign.  They are held instead to the CPU optimizer's
# update fed the card's own gradients, to two float32 steps of the
# parameter plus 1e-5 lr (the update's rounding).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3
TRAIN_PARAM_RTOL = 2.4e-7
TRAIN_PARAM_ATOL_LR = 1e-5
STREAM_TRAIN_CLIPS = 4
STREAM_TRAIN_SECONDS = 4.0
STREAM_TRAIN_LR = 2e-3
STREAM_TRAIN_STEPS = 20
FT_STEPS = 20
SMALL_TRAIN_LOSS_RTOL = 1e-4


class cudnn_deterministic:
    """cuDNN's deterministic algorithms inside the block (its default
    backward-filter algorithms may sum with atomics), for runs compared
    bit for bit."""

    def __enter__(self):
        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.was


def train_batch(cfg, seed: int, dev, batch: int = TRAIN_BATCH, seconds: float = TRAIN_SECONDS,
                tokens: int = TRAIN_TOKENS):
    """B synthetic clips, the last quarter of some cut (ragged lengths), and
    random target tokens of ragged counts, as a ``train.step.Batch``."""
    from moonshine_tpu_torch.train.step import Batch

    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    audio = np.stack([synthetic_clip(seconds, seed + i) for i in range(batch)])
    lengths = n - rng.integers(0, n // 4, batch)
    lengths[0] = n
    tokens_in = rng.integers(3, cfg.vocab_size, (batch, tokens))
    tokens_in[:, 0] = cfg.decoder_start_token_id
    tokens_out = rng.integers(3, cfg.vocab_size, (batch, tokens))
    counts = rng.integers(tokens // 2, tokens + 1, batch)
    mask = np.arange(tokens)[None] < counts[:, None]
    return Batch(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        audio.astype(np.float32), lengths.astype(np.int64), tokens_in.astype(np.int64),
        tokens_out.astype(np.int64), mask)))


def _named(model, grads: bool = False) -> dict:
    from moonshine_tpu_torch.train.step import trainable_parameters

    return {n: (p.grad if grads else p).detach().float().cpu()
            for n, p in trainable_parameters(model)}


def _grad_gap(card: dict, cpu: dict) -> float:
    """The largest gradient difference as a fraction of its leaf's
    largest |g| on the CPU."""
    return max(float((card[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
               for k, v in cpu.items())


def _param_gap(card: dict, cpu: dict) -> float:
    return max(float((card[k] - v).abs().max()) for k, v in cpu.items())


def replay_update(base, optimizer, grads: dict) -> dict:
    """The first update of ``base``'s trainable parameters (a CPU model) by
    a fresh CPU ``optimizer`` fed ``grads``: what a step that computed
    those gradients must have written."""
    from moonshine_tpu_torch.train.step import trainable_parameters

    model = copy.deepcopy(base)
    named = dict(trainable_parameters(model))
    for name, p in named.items():
        p.requires_grad_(True)
        p.grad = grads[name].clone()
    optimizer(list(named.values())).step()
    return _named(model)


def _replay_excess(card: dict, replayed: dict, lr: float) -> float:
    """The largest |card - replayed| less its bound, over every element
    (<= 0 when every element is inside)."""
    return max(float(((card[k] - v).abs() - TRAIN_PARAM_RTOL * v.abs()).max())
               for k, v in replayed.items()) - TRAIN_PARAM_ATOL_LR * lr


def hold_step(what: str, card_loss, cpu_loss, card_grads: dict, cpu_grads: dict,
              card_params: dict, cpu_params: dict, replayed: dict, lr: float,
              grad_rel: float = TRAIN_GRAD_REL, loss_rtol: float = TRAIN_LOSS_RTOL) -> dict:
    """One optimizer step on the card against the same step on the CPU:
    the loss and the gradients against the CPU's, the updated parameters
    against ``replayed`` (``replay_update`` of the card's gradients), held
    to the bounds above; raises with the numbers if it fails.  The gap to
    the CPU's own updated parameters is printed, not held."""
    loss_gap = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_gap = _grad_gap(card_grads, cpu_grads)
    param_gap = _param_gap(card_params, cpu_params)
    replay_gap = _param_gap(card_params, replayed)
    excess = _replay_excess(card_params, replayed, lr)
    out = {"loss_card": float(card_loss), "loss_cpu": float(cpu_loss), "loss_rel_gap": loss_gap,
           "grad_rel_gap": grad_gap, "param_gap_to_cpu_step": param_gap,
           "param_gap_to_replay": replay_gap, "param_replay_excess": excess,
           "loss_rtol": loss_rtol, "grad_rel": grad_rel}
    ok = loss_gap <= loss_rtol and grad_gap <= grad_rel and excess <= 0
    log(f"  {what}: loss card {float(card_loss):.6f} cpu {float(cpu_loss):.6f} (rel gap "
        f"{loss_gap:.3e}, tol {loss_rtol:g}); gradients within {grad_gap:.3e} of each leaf's "
        f"largest |g| (tol {grad_rel:g}); parameters within {replay_gap:.3e} of the cpu "
        f"optimizer fed the card's gradients (bound rtol {TRAIN_PARAM_RTOL:g} + "
        f"{TRAIN_PARAM_ATOL_LR:g} lr, excess {excess:.3e}); {param_gap:.3e} from the cpu's own "
        f"step (not held) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: the card's step differs from the CPU's beyond its bounds")
    return out


def phase_train_step(ea, card: str, dev: str = "cuda") -> dict:
    """Tiny at full width (288 wide, 6 + 6 layers, vocabulary 32,768) from a
    seed, float32, TF32 off: one AdamW step (``train.step.make_train_step``,
    optax's defaults) on B=8 synthetic 10 s clips with random tokens (S=40,
    ragged masks), on the card and on the CPU from the same weights, held
    to the bounds above.  Then 50 steps on that batch on the card: the loss
    must fall, and its ratio is printed beside PERF.md's prediction; the
    median step time, training audio-s/s and tokens/s, the peak memory,
    and one step traced for the device's idle share and its launches.  The
    training path encodes with the split-head attention, so K1 must not
    launch."""
    from moonshine_tpu_torch.core.config import TINY
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.train import step as ts

    cfg = TINY
    base = mm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch_cpu = train_batch(cfg, 1, "cpu")
    batch = type(batch_cpu)(*(x.to(dev) for x in batch_cpu))
    opt = ts.adamw(TRAIN_LR)
    step = ts.make_train_step(cfg, opt)
    t0 = time.perf_counter()
    cpu_state, cpu_m = step(ts.make_train_state(base, opt), batch_cpu)
    cpu_s = time.perf_counter() - t0
    zero_launch_count(ea.encoder_attention_packed)
    # The peak counts all that is allocated on the card, what earlier
    # phases still hold (printed beside it) included.
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = ts.make_train_state(copy.deepcopy(base).to(dev), opt, copy_params=False)
    state, m = step(state, batch)
    torch.cuda.synchronize()
    card_grads = _named(state.params, True)
    held = hold_step("one AdamW step, card against cpu", m["loss"], cpu_m["loss"],
                     card_grads, _named(cpu_state.params, True), _named(state.params),
                     _named(cpu_state.params), replay_update(base, opt, card_grads), TRAIN_LR)
    del cpu_state

    losses, times = [float(m["loss"])], []
    for _ in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # reads the card: the step has ended
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    trace = traced(lambda: step(state, batch))
    k1 = launch_count(ea.encoder_attention_packed)
    step_ms = statistics.median(times) * 1e3
    tokens = int(batch.token_mask.sum())
    ratio = losses[-1] / losses[0]
    out = {"cfg": "tiny", "batch": TRAIN_BATCH, "seconds": TRAIN_SECONDS, "tokens": tokens,
           "lr": TRAIN_LR, "held": held, "cpu_step_s": cpu_s, "losses": losses,
           "loss_ratio": ratio, "predicted_ratio": TRAIN_PREDICTED_RATIO, "step_ms": step_ms,
           "step_ms_spread": [min(times) * 1e3, max(times) * 1e3],
           "audio_s_per_s": TRAIN_BATCH * TRAIN_SECONDS / (step_ms / 1e3),
           "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak,
           "held_before_bytes": held_before, "trace": trace,
           "k1_launches": k1}
    log(f"  {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} (ratio {ratio:.4f}, "
        f"predicted <= {TRAIN_PREDICTED_RATIO}); step {step_ms:.2f} ms median "
        f"({out['step_ms_spread'][0]:.2f}-{out['step_ms_spread'][1]:.2f}), "
        f"{out['audio_s_per_s']:.1f} training audio-s/s, {out['tokens_per_s']:.0f} tokens/s, "
        f"peak {peak / 2**30:.3f} GiB ({held_before / 2**30:.3f} GiB held before the phase); "
        f"one step traced: {trace['wall_ms']:.2f} ms wall, "
        f"{trace['device_ms']:.2f} ms of kernels, idle {trace['idle_share']:.3f}, "
        f"{trace['launches']} launches; K1 launches {k1}; cpu step {cpu_s:.2f} s; on {card}")
    log("  the traced step's kernels by device time: " + "; ".join(
        f"{name} {ms:.3f} ms x{count}" for name, ms, count in trace["top"]))
    if not losses[-1] < 0.9 * losses[0] or not all(np.isfinite(losses)):
        raise SystemExit(f"the train step's loss did not fall: {losses[0]} -> {losses[-1]}")
    if k1:
        raise SystemExit("the training path launched K1, which has no backward")
    return out


def finetune_corpus(root: str, n: int = 8, seed: int = 60):
    """n wav + txt pairs of 3-9 s and a tokenizer that spells their texts:
    ``w<i>`` for a first word, ``▁w<i>`` for the others."""
    from moonshine_tpu_torch.audio.wav import save_wav
    from moonshine_tpu_torch.core.config import TINY
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer

    first = 1000
    vocab = ([b"<unk>", b"<s>", b"</s>"] + [f"w{i}".encode() for i in range(3, first)]
             + [f"▁w{i}".encode() for i in range(first, TINY.vocab_size)])
    os.makedirs(root, exist_ok=True)
    for i, seconds in enumerate(np.linspace(3.0, 9.0, n)):
        save_wav(os.path.join(root, f"ft{i:02d}.wav"), synthetic_clip(seconds, seed + i),
                 SAMPLE_RATE)
        with open(os.path.join(root, f"ft{i:02d}.txt"), "w") as f:
            f.write(f"w{3 + i} w{first + 7 * i} w{first + 100 + i} w{first + 200 + 3 * i}\n")
    tok_path = os.path.join(root, "tokenizer.bin")
    with open(tok_path, "wb") as f:
        f.write(BinTokenizer(vocab).to_bytes())
    return tok_path


def phase_finetune_and_checkpoint(ea, tmp: str, card: str, dev: str = "cuda") -> dict:
    """``train.finetune.finetune`` of Tiny (full width, from a seed) over a
    synthetic wav + txt corpus (8 clips of 3-9 s) with a synthetic
    BinTokenizer, on the card: its loss must fall.  Then
    ``export_safetensors`` -> ``import_safetensors`` -> ``export_safetensors``
    must give the same file byte for byte and the same tensors; a
    ``TrainState`` checkpoint round trip must resume the exact next step
    (its loss and every parameter bit-equal to the uninterrupted run's);
    and the adapted weights transcribe through
    ``Transcriber(...).with_params(...)`` on the card (K1 in its encode)."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.core.config import TINY, TranscriberOptions, VadOptions
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.eval.librispeech import iter_librispeech
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.train import checkpoint as tc
    from moonshine_tpu_torch.train import finetune as tf
    from moonshine_tpu_torch.train import step as ts

    cfg = TINY
    root = os.path.join(tmp, "ft_corpus")
    tok_path = finetune_corpus(root)
    tok = BinTokenizer.from_file(tok_path)
    examples = [(u.load_audio(), u.text) for u in iter_librispeech(root)]
    init = mm.init_params(cfg, torch.Generator().manual_seed(1), dev)
    t0 = time.perf_counter()
    res = tf.finetune(cfg, tok, examples, init_params=init, steps=FT_STEPS, batch_size=8,
                      learning_rate=1e-3, log_every=5)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    log(f"  finetune: {res.examples} clips, {res.steps} steps in {ft_s:.2f} s, losses "
        f"{[round(x, 4) for x in res.losses]}")
    if not res.losses[-1] < res.losses[0]:
        raise SystemExit("finetune did not lower its loss")

    first, again = os.path.join(tmp, "ft.safetensors"), os.path.join(tmp, "ft_again.safetensors")
    tc.export_safetensors(first, res.params)
    back = tc.import_safetensors(first, res.params, cfg)
    tc.export_safetensors(again, back)
    with open(first, "rb") as f1, open(again, "rb") as f2:
        same_bytes = f1.read() == f2.read()
    same_tensors = all(torch.equal(a, b) for a, b in zip(
        _named(res.params).values(), _named(back).values()))

    opt = ts.adamw(1e-3)
    step = ts.make_train_step(cfg, opt)
    batches = list(tf._batches(cfg, examples, tok, 8, dev))
    state, _ = step(ts.make_train_state(res.params, opt, cfg=cfg), batches[0])
    ckpt = os.path.join(tmp, "state.safetensors")
    tc.save_checkpoint(ckpt, state)
    restored = tc.restore_checkpoint(ckpt, ts.make_train_state(init, opt))
    with cudnn_deterministic():
        cont, m_cont = step(state, batches[-1])
        resumed, m_res = step(restored, batches[-1])
    resumes = (resumed.step == cont.step == 2 and torch.equal(m_cont["loss"], m_res["loss"])
               and all(torch.equal(a, b) for a, b in zip(_named(cont.params).values(),
                                                       _named(resumed.params).values())))

    zero_launch_count(ea.encoder_attention_packed)
    t = Transcriber(model=cfg, tokenizer_path=tok_path, device=dev,
                    options=TranscriberOptions(vad=VadOptions(threshold=0.0)))
    transcript = t.with_params(res.params).load().transcribe(examples[0][0])
    k1 = launch_count(ea.encoder_attention_packed)
    lines = [line.text for line in transcript.lines]
    log(f"  export -> import -> export: same bytes {same_bytes}, same tensors {same_tensors}; "
        f"train-state checkpoint resumes the exact next step: {resumes}; "
        f"Transcriber.with_params: {len(lines)} line(s) {lines[:2]}, K1 launches {k1}; on {card}")
    if not (same_bytes and same_tensors and resumes and lines and k1):
        raise SystemExit("the finetune and checkpoint phase failed a check")
    return {"steps": res.steps, "losses": res.losses, "finetune_s": ft_s,
            "same_bytes": same_bytes, "resumes": resumes, "lines": len(lines),
            "k1_launches": k1}


def phase_weight_tp(ea, bg, tmp: str, card: str, dev: str = "cuda") -> dict:
    """Weight tensor parallelism (``parallel.sharding.shard_params``) on a
    world-1 NCCL group's 1x1 mesh, Tiny at full width, float32: the sharded
    train step (``shard_train_state``, ``make_train_step(..., mesh)``)
    against the unsharded one, and ``evaluate(mesh=)`` (greedy and beam 4)
    against ``evaluate()`` over 4 clips of the finetune corpus.  The counts of K1-K4
    are set to 0 before the mesh's runs and read after them: beside
    ``evaluate`` (float KV: K3), an encode with the packed attention (K1 on
    the rank's heads), a greedy decode and an int8-KV beam 4 decode (K3 and
    K4 on the rank's head-sharded caches) of the same split model.  The
    encode and greedy decode are then compared with the unsharded model's
    bit for bit (repair 2 of the open ``[sharded path]`` entry), and the
    decodes' tokens must be equal."""
    import torch.distributed as dist

    from moonshine_tpu_torch.core.config import TINY
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.decoding.beam import beam_decode
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.eval.librispeech import evaluate
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.parallel.distributed import initialize
    from moonshine_tpu_torch.parallel.mesh import make_mesh
    from moonshine_tpu_torch.parallel.sharding import shard_params
    from moonshine_tpu_torch.train import step as ts

    cfg = TINY
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    initialize(device=dev)
    mesh = make_mesh(data=1, model=1, device_type=dev)
    try:
        base = mm.init_params(cfg, torch.Generator().manual_seed(2), dev)
        batch = train_batch(cfg, 5, dev)
        opt = ts.adamw(TRAIN_LR)
        with cudnn_deterministic():
            plain, m_plain = ts.make_train_step(cfg, opt)(ts.make_train_state(base, opt), batch)
            sharded = ts.shard_train_state(mesh, ts.make_train_state(base, opt))
            sharded, m_sharded = ts.make_train_step(cfg, opt, mesh)(sharded, batch)
        p_plain, p_sharded = _named(plain.params), _named(sharded.params)
        g_plain, g_sharded = _named(plain.params, True), _named(sharded.params, True)
        # A group of one runs the unsharded step's arithmetic: the loss,
        # every gradient and every updated parameter must be bit-equal.
        step_bits = torch.equal(m_plain["loss"], m_sharded["loss"]) and all(
            torch.equal(g_plain[k], g_sharded[k]) and torch.equal(p_plain[k], p_sharded[k])
            for k in p_plain)
        loss_gap = abs(float(m_plain["loss"]) - float(m_sharded["loss"]))
        grad_gap = _grad_gap(g_sharded, g_plain)
        param_gap = _param_gap(p_sharded, p_plain)
        del plain, sharded

        # Larger weights than the initializer's make the random model emit
        # tokens before EOS (tests/test_torch_eval.py's scaling).
        model = copy.deepcopy(base)
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() >= 2:
                    p.mul_(3.0)
        mm.prepare_rotary_params(model, cfg, refresh=True)
        root = os.path.join(tmp, "ft_corpus")
        tok = BinTokenizer.from_file(os.path.join(root, "tokenizer.bin"))
        audio = torch.from_numpy(np.stack([synthetic_clip(9.26, 70 + i) for i in range(8)])).to(dev)
        caps = torch.full((8,), 40, device=dev)
        reset_launches(ea, bg)
        t0 = time.perf_counter()
        on_mesh = {b: evaluate(model, cfg, tok, root, batch_size=4, limit=4, beam_size=b,
                               mesh=mesh, return_texts=True) for b in (1, BEAM_SIZE)}
        split = shard_params(mesh, model)
        with torch.inference_mode():
            mem_s, mask_s = mm.encode(split, cfg, audio)
            greedy_s = greedy_decode(split, cfg, mem_s, mask_s, max_tokens=40, token_caps=caps)
            beam_s = beam_decode(split, cfg, mem_s, mask_s, beam_size=BEAM_SIZE, max_tokens=40,
                                 token_caps=caps, kv_int8=True)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        launches = kernel_launches(ea, bg)
        plain_eval = {b: evaluate(model, cfg, tok, root, batch_size=4, limit=4, beam_size=b,
                                  return_texts=True) for b in (1, BEAM_SIZE)}
        with torch.inference_mode():
            mem, mask = mm.encode(model, cfg, audio)
            greedy = greedy_decode(model, cfg, mem, mask, max_tokens=40, token_caps=caps)
            beam = beam_decode(model, cfg, mem, mask, beam_size=BEAM_SIZE, max_tokens=40,
                               token_caps=caps, kv_int8=True)
        checks = {
            "evaluate(mesh=) greedy == evaluate()": on_mesh[1]["hyps"] == plain_eval[1]["hyps"]
            and on_mesh[1]["wer"] == plain_eval[1]["wer"],
            f"evaluate(mesh=) beam {BEAM_SIZE} == evaluate()":
                on_mesh[BEAM_SIZE]["hyps"] == plain_eval[BEAM_SIZE]["hyps"]
                and on_mesh[BEAM_SIZE]["wer"] == plain_eval[BEAM_SIZE]["wer"],
            "greedy tokens on the mesh == unsharded": torch.equal(greedy_s.tokens, greedy.tokens),
            "int8 beam tokens on the mesh == unsharded": torch.equal(beam_s.tokens, beam.tokens),
            "sharded train step bit-equal (loss, gradients, parameters)": step_bits,
        }
        encode_bits = torch.equal(mem_s, mem)
        greedy_bits = torch.equal(greedy_s.tokens, greedy.tokens) and torch.equal(
            greedy_s.lengths, greedy.lengths)
        log(f"  {dist.get_backend()} group of {dist.get_world_size()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        log(f"  sharded train step vs unsharded: bit-equal {step_bits} (loss gap {loss_gap:.3e}, "
            f"gradient gap {grad_gap:.3e} of each leaf's largest |g|, parameter gap "
            f"{param_gap:.3e})")
        log(f"  repair 2: encode on the 1x1 weight-TP mesh == unsharded: "
            f"{'bit-identical' if encode_bits else 'DIFFER'}; greedy: "
            f"{'bit-identical' if greedy_bits else 'DIFFER'}")
        if not encode_bits:
            diff = (mem_s.float() - mem.float()).abs()
            log(f"    memory: {int((diff > 0).sum())} of {diff.numel()} values differ, by at "
                f"most {float(diff.max()):.3e}")
        for name, ok in checks.items():
            log(f"  {name}: {'ok' if ok else 'FAIL'}")
        log(f"  the mesh's runs took {mesh_s:.2f} s on {card}; launches {launches}; "
            f"greedy hyps {on_mesh[1]['hyps'][:2]}")
        if not all(checks.values()):
            raise SystemExit("weight tensor parallelism differs from the unsharded model")
        if not (launches["gather_kv_rows"] and launches["gather_scale_rows"]
                and launches["encoder_attention_packed"] == cfg.encoder_layers):
            raise SystemExit(f"the weight-TP path launched {launches}")
        return {"backend": dist.get_backend(), "mesh": list(mesh.shape), "step_bits": step_bits,
                "loss_gap": loss_gap, "grad_gap": grad_gap, "param_gap": param_gap,
                "encode_bits": encode_bits,
                "greedy_bits": greedy_bits, "checks": checks, "launches": launches,
                "mesh_s": mesh_s}
    finally:
        dist.destroy_process_group()


def _stream_examples(cfg, seed: int):
    rng = np.random.default_rng(seed)
    n = int(STREAM_TRAIN_SECONDS * SAMPLE_RATE) // cfg.frame_len * cfg.frame_len
    out = []
    for i in range(STREAM_TRAIN_CLIPS):
        toks = list(rng.integers(3, cfg.vocab_size, int(rng.integers(12, 21))))
        out.append((synthetic_clip(STREAM_TRAIN_SECONDS, seed + i)[:n],
                    np.array([cfg.bos_id] + toks), np.array(toks + [cfg.eos_id]),
                    np.ones(len(toks) + 1, bool)))
    return out


def phase_streaming_train(card: str, dev: str = "cuda") -> dict:
    """``tiny_streaming`` at full width from a seed, float32: the batched
    overfit step (``train.streaming_step.make_batched_overfit_step``, Adam)
    on 4 synthetic clips of 4 s with random tokens, its first step on the
    card against the CPU's (the bounds of ``[train step]``), then 20 steps
    on the card: the loss must fall; the median step time, and one more
    step traced for the device's idle share and its launches."""
    from moonshine_tpu_torch.core.config import STREAMING_ARCHS
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.train import step as ts
    from moonshine_tpu_torch.train import streaming_step as tss

    cfg = STREAMING_ARCHS["tiny_streaming"]
    examples = _stream_examples(cfg, 80)
    base = ms.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    step = tss.make_batched_overfit_step(cfg, ts.adam(STREAM_TRAIN_LR), examples)

    t0 = time.perf_counter()
    cpu_model, _, cpu_loss = step(copy.deepcopy(base))
    cpu_s = time.perf_counter() - t0
    model, opt, loss = step(copy.deepcopy(base).to(dev))
    card_grads = _named(model, True)
    held = hold_step("one Adam step, card against cpu", loss, cpu_loss, card_grads,
                     _named(cpu_model, True), _named(model), _named(cpu_model),
                     replay_update(base, ts.adam(STREAM_TRAIN_LR), card_grads), STREAM_TRAIN_LR)
    losses, times = [float(loss)], []
    for _ in range(STREAM_TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    trace = traced(lambda: step(model, opt))
    log(f"  {STREAM_TRAIN_STEPS} batched steps of {STREAM_TRAIN_CLIPS} x "
        f"{STREAM_TRAIN_SECONDS:g} s: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{step_ms:.2f} ms median, {STREAM_TRAIN_CLIPS * STREAM_TRAIN_SECONDS / (step_ms / 1e3):.1f} "
        f"training audio-s/s; one more step traced: {trace['wall_ms']:.2f} ms wall, "
        f"{trace['device_ms']:.2f} ms of kernels, idle {trace['idle_share']:.3f}, "
        f"{trace['launches']} launches; cpu step {cpu_s:.2f} s; on {card}")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise SystemExit(f"the streaming trainer's loss did not fall: {losses}")
    return {"held": held, "losses": losses, "step_ms": step_ms, "cpu_step_s": cpu_s,
            "trace": trace}


def phase_small_trainers(card: str, dev: str = "cuda") -> dict:
    """The spelling and diarization trainers at the JAX package's defaults,
    on the card: ``train.spelling.train`` (10 epochs of batch 32, lr 3e-3)
    on 64 ``spelling_clips`` with labels i % 36; ``train_segmentation`` and
    ``train_embedding`` (dim 64, 120 steps each) on the crops of the two
    synthetic voices of ``two_speaker_conversation`` (30 s each), then
    ``fit_plda`` on the trained embeddings.  Each trainer's first step from
    the same weights is run on the CPU too: its loss within rtol 1e-4.  The
    losses after the default step counts and each trainer's time on the
    card are printed."""
    from moonshine_tpu_torch.models import diarization as dm
    from moonshine_tpu_torch.models import spelling as sp
    from moonshine_tpu_torch.train import diarization as tdz
    from moonshine_tpu_torch.train import spelling as tsp

    out: dict = {}

    def first_step(what, run):
        cpu, card_loss = run("cpu"), run(dev)
        gap = abs(card_loss - cpu) / abs(cpu)
        log(f"  {what}: first loss card {card_loss:.6f} cpu {cpu:.6f} (rel gap {gap:.3e}, tol "
            f"{SMALL_TRAIN_LOSS_RTOL:g})")
        if not gap <= SMALL_TRAIN_LOSS_RTOL:
            raise SystemExit(f"{what}: the card's first step differs from the CPU's")
        out[f"{what} first loss"] = {"card": card_loss, "cpu": cpu, "rel_gap": gap}

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    clips = spelling_clips(SPELLING_CLIPS)
    data = tsp.SpellingDataset(clips, (np.arange(SPELLING_CLIPS) % 36).astype(np.int32),
                               [f"clip{i}" for i in range(SPELLING_CLIPS)])
    sp_init = sp.init_params(torch.Generator().manual_seed(4), "cpu")
    first_step("spelling", lambda d: tsp.train(
        tsp.SpellingDataset(clips[:32], data.labels[:32], data.names[:32]), epochs=1,
        init_params=copy.deepcopy(sp_init).to(d)).losses[0])
    res, s = timed(lambda: tsp.train(data, init_params=copy.deepcopy(sp_init).to(dev)))
    out["spelling"] = {"steps": len(res.losses), "first": res.losses[0], "last": res.losses[-1],
                       "accuracy": res.train_accuracy, "seconds": s}
    log(f"  spelling train: {len(res.losses)} steps, loss {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f}, train accuracy {res.train_accuracy:.3f}, {s:.2f} s on {card}")

    waves = [synthetic_voice(30.0, 120.0, 1.0, 100), synthetic_voice(30.0, 230.0, 1.8, 101)]
    crops = [tdz.voiced_crops(w) for w in waves]
    seg_init = dm.init_segmentation_params(torch.Generator().manual_seed(5), dim=64, depth=1,
                                           device="cpu")
    emb_init = dm.init_embedding_params(torch.Generator().manual_seed(6), dim=64, device="cpu")
    first_step("segmentation", lambda d: tdz.train_segmentation(
        None, crops, steps=1, init_params=copy.deepcopy(seg_init).to(d))["final_loss"])
    first_step("embedding", lambda d: tdz.train_embedding(
        None, crops, steps=1, init_params=copy.deepcopy(emb_init).to(d))["final_loss"])
    seg, seg_s = timed(lambda: tdz.train_segmentation(
        None, crops, init_params=copy.deepcopy(seg_init).to(dev)))
    emb, emb_s = timed(lambda: tdz.train_embedding(
        None, crops, init_params=copy.deepcopy(emb_init).to(dev)))
    xs, ws, ys = emb["examples"]
    with torch.inference_mode():
        trained = dm.embedding_forward(emb["params"], torch.from_numpy(xs).to(dev),
                                       torch.from_numpy(ws).to(dev)).cpu().numpy()
    plda, plda_s = timed(lambda: tdz.fit_plda(trained, ys))
    out.update({"segmentation": {"final_loss": seg["final_loss"], "seconds": seg_s},
                "embedding": {"final_loss": emb["final_loss"], "seconds": emb_s,
                              "examples": int(len(ys))},
                "plda": {"seconds": plda_s, "phi_top": float(plda.phi_between[0])}})
    log(f"  train_segmentation (dim 64, 120 steps): final loss {seg['final_loss']:.4f}, "
        f"{seg_s:.2f} s; train_embedding (dim 64, 120 steps, {len(ys)} examples): final loss "
        f"{emb['final_loss']:.4f}, {emb_s:.2f} s; fit_plda {plda_s:.3f} s, top phi "
        f"{float(plda.phi_between[0]):.3f}; on {card}")
    if not all(np.isfinite([seg["final_loss"], emb["final_loss"], res.losses[-1]])):
        raise SystemExit("a trainer's loss is not finite")
    return out


# [g2p and tagger train]: the reference corpora the Japanese reader and the
# tagger train on are not in the repository; these synthetic ones are
# written in their formats from the in-repo tables (the CPU tests train on
# them too).
CORPUS_JA_LINES = 100
CORPUS_ZH_LINES = 96
CORPUS_TAGS = ("NOUN", "VERB", "ADJ", "ADV", "PROPN", "NUM", "PRON", "AUX")
JA_PARTICLES = ("は", "の", "を", "に", "が", "で", "と", "も", "から", "まで")
# Card against CPU: steps 1..G2P_HOLD_STEPS after the first (whose lr is 0
# under the warm-up from 0) from the same weights on the same batches: each
# loss to TRAIN_LOSS_RTOL; the last step's gradients to TRAIN_GRAD_REL of
# each leaf's largest |g|, its parameters to the CPU optimizer (with the
# card's moments) fed the card's gradients, as [train step] holds them.
G2P_HOLD_STEPS = 4
G2P_TIMED_STEPS = 50
# Reduced step counts (defaults 1,200 and 800): the synthetic corpora are
# small, and 300 steps, the JAX package's own test counts, keep the phase
# near 60 s with its CPU halves; the full defaults show nothing more of the
# port on these corpora.
JA_READER_STEPS = 300
TOK_POS_STEPS = 300
JA_NEURAL_LINE = "山川の学校で数字を使用する。"


def write_reference_corpora(root: str, seed: int = 0) -> dict:
    """Synthetic stand-ins for the reference's ja wiki corpus (surface/UPOS
    tokens and golden IPA words, ``tok_pos_wiki_100.txt`` and
    ``onnx_g2p_wiki_100.txt``) and zh tagger corpus
    (``tok_pos_wiki_filtered.txt``) under ``root`` in the reference's layout
    (``core/moonshine-tts/tests/data/{ja,zh_hans}``).  Japanese lines join
    kanji words of ``tts/data/ja_core_words.tsv`` and of
    ``tests/data/g2p_ref/ja_readings.tsv`` (read through ``kana_to_ipa``
    where stored as kana) with kana particles; Chinese lines join words of
    ``tts/data/zh_pinyin.tsv``, each with one fixed tag.  -> {"ja": dir,
    "zh": file}."""
    from moonshine_tpu_torch.tts import ja_align, lang_rules

    rng = np.random.default_rng(seed)
    here = os.path.dirname(os.path.abspath(__file__))
    ja_words = {k: v for k, v in lang_rules.ja_core_lexicon().items()
                if all(ja_align.is_kanji(c) for c in k) and len(k) <= 4}
    with open(os.path.join(here, "tests", "data", "g2p_ref", "ja_readings.tsv"),
              encoding="utf-8") as f:
        for line in f:
            k, _, v = line.rstrip("\n").partition("\t")
            if v and not k.startswith("#") and all(ja_align.is_kanji(c) for c in k):
                ja_words.setdefault(k, v)
    surfaces = sorted(ja_words)
    data = os.path.join(root, "core", "moonshine-tts", "tests", "data")
    os.makedirs(os.path.join(data, "ja"))
    os.makedirs(os.path.join(data, "zh_hans"))
    tok_lines, gold_lines = [], []
    for _ in range(CORPUS_JA_LINES):
        toks, gold = [], []
        for _ in range(int(rng.integers(2, 6))):
            word = surfaces[int(rng.integers(len(surfaces)))]
            particle = JA_PARTICLES[int(rng.integers(len(JA_PARTICLES)))]
            toks += [f"{word}/NOUN", f"{particle}/ADP"]
            gold += [ja_words[word], lang_rules.kana_to_ipa(particle)]
        tok_lines.append(" ".join(toks + ["。/PUNCT"]))
        gold_lines.append(" ".join(gold))
    with open(os.path.join(data, "ja", "tok_pos_wiki_100.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tok_lines) + "\n")
    with open(os.path.join(data, "ja", "onnx_g2p_wiki_100.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(gold_lines) + "\n")
    zh = []
    with open(os.path.join(here, "moonshine_tpu_torch", "tts", "data", "zh_pinyin.tsv"),
              encoding="utf-8") as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                zh.append(line.split("\t", 1)[0])
    tag_of = {w: CORPUS_TAGS[i % len(CORPUS_TAGS)] for i, w in enumerate(sorted(zh))}
    lines = []
    for _ in range(CORPUS_ZH_LINES):
        words = [zh[int(i)] for i in rng.integers(0, len(zh), int(rng.integers(6, 16)))]
        lines.append(" ".join([f"{w}/{tag_of[w]}" for w in words] + ["。/PUNCT"]))
    zh_path = os.path.join(data, "zh_hans", "tok_pos_wiki_filtered.txt")
    with open(zh_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return {"ja": os.path.join(data, "ja"), "zh": zh_path}


def hold_scheduled_steps(what: str, base, make_step, schedule, cfg, data, draw, dev) -> dict:
    """``G2P_HOLD_STEPS + 1`` steps of ``make_step(schedule)`` from the CPU
    model ``base`` on the card and on the CPU, on the same batches (rows
    ``draw()`` of every array of ``data``): the losses of the steps whose lr
    is above 0 to TRAIN_LOSS_RTOL, then the last step through ``hold_step``
    (its replay restores the card's optimizer state from before it).  The
    card's state is returned to be trained on."""
    from moonshine_tpu_torch.train import step as ts
    from moonshine_tpu_torch.train.g2p import train_state

    peak = max(schedule(i) for i in range(G2P_HOLD_STEPS + 1))
    devices = {"cpu": "cpu", "card": dev}
    states = {k: train_state(copy.deepcopy(base).to(d), peak) for k, d in devices.items()}
    step = make_step(schedule)
    losses: dict = {"cpu": [], "card": []}
    for i in range(G2P_HOLD_STEPS + 1):
        idx = draw()
        if i == G2P_HOLD_STEPS:
            before = copy.deepcopy(states["card"].params).cpu()
            opt_before = copy.deepcopy(states["card"].opt_state.state_dict())
        for k, d in devices.items():
            batch = tuple(torch.from_numpy(np.ascontiguousarray(a[idx])).to(d) for a in data)
            states[k], loss = step(states[k], batch, cfg)
            losses[k].append(float(loss))
    lrs = [schedule(i) for i in range(G2P_HOLD_STEPS + 1)]
    gaps = [abs(a - b) / abs(b) for a, b, lr in zip(losses["card"], losses["cpu"], lrs) if lr > 0]
    log(f"  {what}: lr {lrs[0]:g} then {', '.join(f'{x:.3g}' for x in lrs[1:])}; losses card "
        f"{', '.join(f'{x:.6f}' for x in losses['card'])}, cpu "
        f"{', '.join(f'{x:.6f}' for x in losses['cpu'])}; largest rel gap where lr > 0 "
        f"{max(gaps):.3e} (tol {TRAIN_LOSS_RTOL:g})")
    if not max(gaps) <= TRAIN_LOSS_RTOL:
        raise SystemExit(f"{what}: the card's losses differ from the CPU's")
    lr = lrs[-1]

    def resumed(params):
        opt = ts.adamw(lr)(params)
        opt.load_state_dict(opt_before)
        for group in opt.param_groups:
            group["lr"] = lr
        return opt

    card, cpu = states["card"].params, states["cpu"].params
    card_grads = _named(card, True)
    held = hold_step(f"{what}, step {G2P_HOLD_STEPS} (lr {lr:.3g})", losses["card"][-1],
                     losses["cpu"][-1], card_grads, _named(cpu, True), _named(card),
                     _named(cpu), replay_update(before, resumed, card_grads), lr)
    return {"losses_card": losses["card"], "losses_cpu": losses["cpu"], "lrs": lrs,
            "loss_rel_gaps": gaps, "held": held, "state": states["card"]}


def phase_g2p_trainers(tmp: str, card: str, dev: str = "cuda") -> dict:
    """The G2P and tagger trainers on the card at the published widths:
    ``distill("en")`` at its defaults (``G2PModelConfig()``: 128 wide, 2 + 2
    layers, 4 heads, 28 -> 40; 2,000 steps of batch 64 at lr 3e-3 over the
    212 pairs the engine gives without the baked dictionary), then
    ``train_ja_reader`` (``DEFAULT_CFG``) and ``train_tok_pos`` (zh,
    ``TokPosConfig()``: 128 wide, 2 layers, ``max_len`` 192) on
    ``write_reference_corpora``, at JA_READER_STEPS and TOK_POS_STEPS.
    Each trainer's step is first held card against CPU from the same
    weights (``hold_scheduled_steps``); the distill step is timed over
    G2P_TIMED_STEPS more steps, each read back (the median), then over as
    many read back once (steps/s), and one is traced.  The trained models, moved
    to the CPU, predict, annotate and drive ``JapaneseG2P(neural=...)`` as
    on the card."""
    import contextlib
    import io
    from pathlib import Path

    from moonshine_tpu_torch.train import g2p as tg
    from moonshine_tpu_torch.train import ja_reader as tjr
    from moonshine_tpu_torch.train import step as ts
    from moonshine_tpu_torch.train import tok_pos as ttp
    from moonshine_tpu_torch.tts import g2p_transformer as g2pt
    from moonshine_tpu_torch.tts import ja_align, lang_rules
    from moonshine_tpu_torch.tts import tok_pos as tpos

    out: dict = {}
    cfg = g2pt.G2PModelConfig()
    _, pairs = tg.build_dataset("en")
    vocab = g2pt.G2PTransformer.build_out_vocab(ipa for _, ipa in pairs)
    holder = g2pt.G2PTransformer(cfg, g2pt.init_params(
        cfg, torch.Generator().manual_seed(7), len(vocab), device="cpu"), vocab, device="cpu")
    src = np.stack([g2pt.encode_word(w, cfg.max_word) for w, _ in pairs])
    tgt = np.stack([holder.encode_ipa(ipa) for _, ipa in pairs])
    sched = ts.warmup_cosine_decay_schedule(0.0, 3e-3, 100, 2000)
    rng = np.random.default_rng(0)
    draw = lambda: rng.integers(0, len(pairs), size=64)  # noqa: E731
    held = hold_scheduled_steps("distill's step", holder.params, tg.make_train_step, sched, cfg,
                                (src, tgt), draw, dev)
    state = held.pop("state")
    step = tg.make_train_step(sched)
    on_dev = [torch.from_numpy(a).to(dev) for a in (src, tgt)]
    rows = torch.from_numpy(np.stack([draw() for _ in range(2 * G2P_TIMED_STEPS + 1)])).to(dev)
    times = []
    for i in range(G2P_TIMED_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tuple(a[rows[i]] for a in on_dev), cfg)
        float(loss)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G2P_TIMED_STEPS, 2 * G2P_TIMED_STEPS):
        state, loss = step(state, tuple(a[rows[i]] for a in on_dev), cfg)
    torch.cuda.synchronize()
    steps_per_s = G2P_TIMED_STEPS / (time.perf_counter() - t0)
    trace = traced(lambda: step(state, tuple(a[rows[-1]] for a in on_dev), cfg))
    step_ms = statistics.median(times) * 1e3
    log(f"  distill's step (batch 64, G2PModelConfig()): {step_ms:.3f} ms median over "
        f"{G2P_TIMED_STEPS}, each read back ({min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}); "
        f"{steps_per_s:.1f} steps/s over {G2P_TIMED_STEPS} more, read back once; one step "
        f"traced: {trace['wall_ms']:.3f} ms wall, {trace['device_ms']:.3f} ms of kernels, idle "
        f"{trace['idle_share']:.3f}, {trace['launches']} launches; on {card}")
    log("  the traced step's kernels by device time: " + "; ".join(
        f"{name} {ms:.3f} ms x{count}" for name, ms, count in trace["top"]))

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        model, acc = tg.distill("en", log_every=200)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    curve = [float(m) for m in re.findall(r"loss ([0-9.]+)", printed.getvalue())]
    words = [w for w, _ in pairs]
    on_cpu = g2pt.G2PTransformer(cfg, copy.deepcopy(model.params).cpu(), model.out_vocab,
                                 device="cpu")
    preds, cpu_preds = model.predict_batch(words), on_cpu.predict_batch(words)
    same = preds == cpu_preds
    log(f"  distill('en') at its defaults: {len(pairs)} pairs, 2000 steps in {distill_s:.2f} s "
        f"({2000 / distill_s:.1f} steps/s with the data, the logging and the final "
        f"predictions), loss at step 200 {curve[0]:.4f} -> step 2000 {curve[-1]:.4f}, "
        f"exact match {acc:.4f}; predictions on the cpu equal {same}")
    if not same or not np.isfinite(curve).all() or not curve[-1] < curve[0]:
        raise SystemExit("distill on the card: the loss did not fall or the cpu predicts otherwise")
    out["distill"] = {**held, "step_ms": step_ms, "steps_per_s": steps_per_s,
                      "step_ms_spread": [min(times) * 1e3, max(times) * 1e3], "trace": trace,
                      "seconds": distill_s, "loss_curve": curve, "accuracy": acc,
                      "pairs": len(pairs), "cpu_predictions_equal": same}

    # The port's corpus paths point at the synthetic corpora for the two
    # trainers, and back afterwards.
    paths = write_reference_corpora(tmp)
    saved = ja_align.REF_JA_DIR, dict(ttp.CORPORA)
    ja_align.REF_JA_DIR = Path(paths["ja"])
    ttp.CORPORA.update(zh=Path(paths["zh"]), ja=Path(paths["ja"]) / "tok_pos_wiki_100.txt")
    try:
        data, _ = tjr.build_ja_dataset()
        surfaces = [s for s, _ in data]
        in_vocab = g2pt.G2PTransformer.build_in_vocab(surfaces)
        out_vocab = g2pt.G2PTransformer.build_out_vocab(p for _, p in data)
        rcfg = tjr.DEFAULT_CFG
        base = g2pt.init_params(rcfg, torch.Generator().manual_seed(8), len(out_vocab),
                                len(in_vocab) + 4, "cpu")
        reader0 = g2pt.G2PTransformer(rcfg, base, out_vocab, in_vocab, device="cpu")
        r_src = np.stack([reader0.encode_src(s) for s in surfaces])
        r_tgt = np.stack([reader0.encode_ipa(p) for _, p in data])
        rrng = np.random.RandomState(0)
        r_held = hold_scheduled_steps(
            "ja_reader's step", base, tg.make_train_step,
            ts.warmup_cosine_decay_schedule(0.0, tjr.LR, tjr.WARMUP, JA_READER_STEPS), rcfg,
            (r_src, r_tgt), lambda: rrng.randint(0, len(r_src), size=128), dev)
        r_held.pop("state")
        t0 = time.perf_counter()
        reader = tjr.train_ja_reader(steps=JA_READER_STEPS, init_params=base.to(dev))
        torch.cuda.synchronize()
        reader_s = time.perf_counter() - t0
        cpu_reader = g2pt.G2PTransformer(rcfg, copy.deepcopy(reader.params).cpu(),
                                         reader.out_vocab, reader.in_vocab, device="cpu")
        uniq = sorted(set(data))
        r_preds = reader.predict_batch([s for s, _ in uniq])
        r_same = r_preds == cpu_reader.predict_batch([s for s, _ in uniq])
        fit = sum(p == ipa for p, (_, ipa) in zip(r_preds, uniq)) / len(uniq)
        ipa = {}
        for name, r in (("card", reader), ("cpu", cpu_reader)):
            g = lang_rules.JapaneseG2P(lexicon={"学校": "gakkoɯ"}, use_harvested=False,
                                       use_core=False, use_onyomi=False, tagger=False, neural=r)
            ipa[name] = g.word_to_ipa(JA_NEURAL_LINE)
        log(f"  train_ja_reader ({len(data)} pairs, {len(uniq)} distinct, {JA_READER_STEPS} steps "
            f"of batch 128): {reader_s:.2f} s, fit exact match {fit:.4f}, predictions on the cpu "
            f"equal {r_same}; JapaneseG2P(neural=reader) on {JA_NEURAL_LINE!r}: {ipa['card']!r} "
            f"on the card, equal on the cpu {ipa['card'] == ipa['cpu']}")
        if not r_same or ipa["card"] != ipa["cpu"]:
            raise SystemExit("the ja reader trained on the card reads otherwise on the cpu")
        out["ja_reader"] = {**r_held, "seconds": reader_s, "fit": fit, "pairs": len(data),
                            "cpu_predictions_equal": r_same, "neural_line_ipa": ipa["card"]}

        rows = ttp.load_corpus("zh")
        train_rows, held_rows = rows[:int(len(rows) * 0.8)], rows[int(len(rows) * 0.8):]
        chars = sorted({c for text, _ in train_rows for c in text})
        tags = sorted({t for _, toks in train_rows for _, t in toks})
        tcfg = tpos.TokPosConfig()
        t_base = tpos.init_params(tcfg, torch.Generator().manual_seed(9), len(chars) + 2,
                                  len(tags), "cpu")
        labels = ttp.make_labels(train_rows, tcfg, tpos.TokPosTagger(tcfg, t_base, chars, tags,
                                                                      device="cpu"))
        trng = np.random.RandomState(0)
        t_held = hold_scheduled_steps(
            "tok_pos's step", t_base, ttp.make_train_step,
            ts.warmup_cosine_decay_schedule(0.0, ttp.LR, ttp.WARMUP, TOK_POS_STEPS), tcfg,
            labels, lambda: trng.randint(0, len(labels[0]), size=16), dev)
        t_held.pop("state")
        t0 = time.perf_counter()
        tagger, _, _ = ttp.train_tok_pos("zh", steps=TOK_POS_STEPS, init_params=t_base.to(dev))
        torch.cuda.synchronize()
        tagger_s = time.perf_counter() - t0
        cpu_tagger = tpos.TokPosTagger(tcfg, copy.deepcopy(tagger.params).cpu(), tagger.char_vocab,
                                       tagger.tags, device="cpu")
        a_same = all(tagger.annotate(t) == cpu_tagger.annotate(t) for t, _ in rows)
        f1 = {"train": ttp.word_f1(tagger, train_rows), "held": ttp.word_f1(tagger, held_rows),
              "held_pos": ttp.word_f1(tagger, held_rows, with_pos=True)}
        log(f"  train_tok_pos('zh', {TOK_POS_STEPS} steps of batch 16): {tagger_s:.2f} s, seg F1 "
            f"train {f1['train']:.3f} held {f1['held']:.3f}, seg+UPOS held {f1['held_pos']:.3f}; "
            f"annotations on the cpu equal {a_same}; on {card}")
        if not a_same:
            raise SystemExit("the tagger trained on the card annotates otherwise on the cpu")
        out["tok_pos"] = {**t_held, "seconds": tagger_s, "f1": f1, "cpu_annotations_equal": a_same}
    finally:
        ja_align.REF_JA_DIR, ttp.CORPORA = saved
    return out


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
    from moonshine_tpu_torch.ops import int8_kv as q8

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
    log("[kernel vs plain] K5")
    q8_err = phase_q8_vs_plain(q8)
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
    log("[kernel times] K5")
    q8_times = phase_q8_times(q8)

    with tempfile.TemporaryDirectory() as tmp:
        tok_path = os.path.join(tmp, "tokenizer.bin")
        vocab = [b"<unk>", b"<s>", b"</s>"] + [f"▁w{i}".encode() for i in
                                               range(3, BASE.vocab_size)]
        with open(tok_path, "wb") as f:
            f.write(BinTokenizer(vocab).to_bytes())
        log("[main path] Transcriber(model='base') on cuda")
        zero_launch_count(ea.encoder_attention_packed)
        main_path = phase_main_path(ea, tok_path, BASE)
        main_launches = launch_count(ea.encoder_attention_packed)
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
        # The service's paths run no kernel of the JAX package's (the JAX
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
        log("[tts and voice loop] TextToSpeech on cuda; TTS -> Transcriber(model='base') -> agent")
        reset_launches(ea, bg)
        voice = phase_voice_loop(ea, tok_path, card_emb, card)
        voice_launches["voice loop"] = kernel_launches(ea, bg)
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
        # The edges are host code in both packages (no Pallas) around the
        # models above; K1 runs in the Base encodes of the mic, cli
        # transcribe and latency paths (in the [cli and download] and
        # [latency and fleurs] phases the only K1 launches are those of cli
        # transcribe and of the latency bench: the cpu runs count nothing
        # and evaluate_languages encodes with the split-head XLA path).
        t_edges = time.perf_counter()
        log("[native host] libmoonshine_host.so from the port's sources, against the Python paths")
        reset_launches(ea, bg)
        native_host = phase_native_host(card)
        edge_launches = {"native host": kernel_launches(ea, bg)}
        log("[mic] mic.MicTranscriber over a WavSource, Transcriber(model='base') on cuda")
        reset_launches(ea, bg)
        mic = phase_mic(tok_path, tmp, card)
        edge_launches["mic"] = kernel_launches(ea, bg)
        log("[server] TranscriptionServer at server.main's defaults on cuda, without a socket")
        reset_launches(ea, bg)
        server = phase_server(card_emb, cpu_emb, card)
        edge_launches["server"] = kernel_launches(ea, bg)
        del card_emb, cpu_emb
        log("[native client] libmoonshine_client.so and client_selftest from the port's sources")
        reset_launches(ea, bg)
        native_client = phase_native_client(card)
        edge_launches["native client"] = kernel_launches(ea, bg)
        log("[cli and download] cli.main on cuda; download from a local http.server")
        reset_launches(ea, bg)
        cli_download = phase_cli_and_download(ea, catalog_root, tmp, card)
        edge_launches["cli transcribe"] = kernel_launches(ea, bg)
        log("[latency and fleurs] eval/latency and eval/fleurs over Base on cuda")
        reset_launches(ea, bg)
        latency_fleurs = phase_latency_and_fleurs(tok_path, tmp, card)
        edge_launches["latency"] = kernel_launches(ea, bg)
        edges_s = time.perf_counter() - t_edges
        log(f"  kernel launches: {edge_launches}; the six edge phases took {edges_s:.1f} s on "
            f"{card}")
        for path in ("mic", "cli transcribe", "latency"):
            if not edge_launches[path]["encoder_attention_packed"]:
                raise SystemExit(f"K1 did not launch on the {path} path")
        # Training and weight tensor parallelism.  No kernel of the
        # repository has a backward, so the trainers encode with the
        # split-head attention and launch none; the finetuned weights'
        # Transcriber runs K1, and the weight-TP path runs K1 in its encode
        # and K3 and K4 in its beam decodes, on each rank's heads (counted
        # over the mesh's runs only).
        t_train = time.perf_counter()
        log("[train step] Tiny at full width, B=8 x 10 s, S=40: one AdamW step card against "
            "cpu, then 50 steps on cuda")
        reset_launches(ea, bg)
        train_step = phase_train_step(ea, card)
        train_launches = {"train step": kernel_launches(ea, bg)}
        log("[finetune and checkpoint] finetune, safetensors and train-state round trips, "
            "Transcriber.with_params on cuda")
        reset_launches(ea, bg)
        finetune_ckpt = phase_finetune_and_checkpoint(ea, tmp, card)
        train_launches["finetune and checkpoint"] = kernel_launches(ea, bg)
        log("[weight TP] shard_params on the NCCL 1x1 mesh: the train step and evaluate(mesh=)")
        reset_launches(ea, bg)
        weight_tp = phase_weight_tp(ea, bg, tmp, card)
        train_launches["weight TP"] = weight_tp["launches"]
        log("[streaming train] tiny_streaming at full width, 4 clips x 4 s: card against cpu, "
            "then 20 batched steps")
        reset_launches(ea, bg)
        streaming_train = phase_streaming_train(card)
        train_launches["streaming train"] = kernel_launches(ea, bg)
        log("[spelling and diarization train] the JAX defaults on cuda, first steps against cpu")
        reset_launches(ea, bg)
        small_train = phase_small_trainers(card)
        train_launches["spelling and diarization train"] = kernel_launches(ea, bg)
        log("[g2p and tagger train] distill('en'), train_ja_reader and train_tok_pos on cuda, "
            "card against cpu")
        t_g2p = time.perf_counter()
        reset_launches(ea, bg)
        g2p_train = phase_g2p_trainers(os.path.join(tmp, "reference"), card)
        train_launches["g2p and tagger train"] = kernel_launches(ea, bg)
        g2p_train["phase_s"] = time.perf_counter() - t_g2p
        train_s = time.perf_counter() - t_train
        log(f"  kernel launches: {train_launches}; the six training phases took "
            f"{train_s:.1f} s ([g2p and tagger train] {g2p_train['phase_s']:.1f} s) on {card}")
        for path in ("train step", "streaming train", "spelling and diarization train",
                     "g2p and tagger train"):
            if any(train_launches[path].values()):
                raise SystemExit(f"the {path} path launched a kernel with no backward")

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
                                     **voice_launches, **item12_launches,
                                     **edge_launches, **train_launches}.items()}

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
    q8_main = q8_times["serve cross 3200"]
    kernels.append({
        "name": "attention_dm_q8", "route": "cuda",
        "source": "moonshine_tpu_torch/csrc/int8_attention.cu",
        "replaces": "none: moonshine_tpu/ops/int8_kv.py attention_dm_q8 is XLA code",
        "launches_per_decoder_call": {
            "batched offline decode": batched["q8_launches_per_decoder_call"],
            "w8a8 batched": w8a8_batched["q8_launches_per_decoder_call"],
            "serving": serving["q8_launches_per_decoder_call"]},
        "launches_by_path": on_counted_paths("int8_attention"),
        "max_rel_rms_err": q8_err,
        "tol": {k: list(Q8_TOL[getattr(torch, k)]) for k in ("float32", "bfloat16")},
        "shape": q8_main["shape"], "ms": q8_main["kernel_ms"], "kernel_ms": q8_main["kernel_ms"],
        "plain_ms": q8_main["plain_ms"], "library_ms": q8_main["library_ms"],
        "bound_ms": q8_main["bound_ms"], "bound_by": q8_main["bound_by"], "shapes": q8_times})
    record = {"card": card, "torch": torch.__version__, "kernels": kernels,
              "kernel_times": times, "hm_times": hm_times, "f32_times": f32_times,
              "batch_independence": batch_independence, "sass": sass,
              "gather_times": gather_times, "q8_times": q8_times,
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
              "native_host": native_host, "mic": mic, "server": server,
              "native_client": native_client, "cli_and_download": cli_download,
              "latency_and_fleurs": latency_fleurs, "edge_launches": edge_launches,
              "edges_s": edges_s, "train_step": train_step,
              "finetune_and_checkpoint": finetune_ckpt, "weight_tp": weight_tp,
              "streaming_train": streaming_train, "small_trainers": small_train,
              "g2p_train": g2p_train, "train_launches": train_launches, "train_s": train_s,
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
