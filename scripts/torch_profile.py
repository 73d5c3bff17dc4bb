#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's decodes and streams.

    python3 scripts/torch_profile.py [--decode greedy|w8a8|beam|speculative|transcriber|streaming|serving|diarizer] [--batch N]

Profiles the workload of one of ``chip_smoke.py``'s phases:
``chip_smoke.batched_workload`` (greedy, the default; batch 64; ``w8a8``:
the same with the bench's --w8a8 weights) or ``chip_smoke.beam_workload``
(beam 4; batch 128 utterances, the bench's), all Moonshine Base, bf16, int8
KV, 9.26 s clips, random weights, decoding to the full token cap; or
``chip_smoke.speculative_workload`` (the floor: Base verifier, Tiny draft,
gamma 4, float KV, batch 32, the bench's); or ``segment_workload``
(``transcriber``: one segment of the Transcriber's main path, Base in
float32, B=1).  After a warm-up it traces one encode and one whole decode
with ``torch.profiler`` and prints, for each, from that one traced run: its
wall time, the summed device time of its kernels, the device's idle share
over the wall time, and the kernels that take the most device time.
``streaming`` traces instead one whole stream of ``chip_smoke.py
[streaming]`` (``medium_streaming``, 10 s in 0.5 s chunks, float32, one
stream) after a warm-up stream.  ``serving`` traces one cohort (32 streams)
of ``chip_smoke.py [serving]`` (``medium_streaming``, bf16, int8 KV, 0.64 s
updates, 15 s segments, the bench's staggered pre-fill): after three
untraced decoding updates, one decoding update and one ingest-only update,
each with its decoder calls counted, the launches a decoder call and the
share of device time in dtype copies (``direct_copy_kernel``; the int8
caches are read in place by K5, ``ops/int8_kv.attention_dm_q8``).
``diarizer`` traces one analysis step of ``chip_smoke.py [speakers and
spelling]``'s diarizer (the API's seeds; 2 s of a synthetic two-speaker
conversation after 30 s untraced: two 10 s windows segmented, their
speakers embedded, the turns clustered again).
Wall times include the profiler's own cost on the host.  Needs one CUDA device; the gzipped Chrome trace of the decode
(or the stream) goes to chiprun_out/torch_profile_<decode>_trace.json.gz.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (SAMPLE_RATE, batched_workload, beam_workload,  # noqa: E402
                        speculative_workload)
from moonshine_tpu_torch.core.config import BASE, TINY  # noqa: E402
from moonshine_tpu_torch.core.device import resolve_device  # noqa: E402


OWN_KERNELS = ("encoder_attention_mma_kernel", "encoder_attention_f32_kernel",
               "gather_rows")  # csrc/*.cu


def device_us(prof) -> tuple[float, list]:
    """Summed kernel time (us) and the top kernels by device time."""
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return sum(e.self_device_time_total for e in rows), rows


def segment_workload(cfg, seconds: float = 48.0):
    """One segment of the Transcriber's main path on the card, as
    ``OfflineBackend.transcribe_segment`` runs it: Base in float32 (random
    weights from seed 0), ``seconds`` of noise at 0.1 (seed 1) padded to its
    duration bucket (48 s: the 64 s bucket, T=2,665), encoded with
    ``attn_impl="auto"`` (K1's float32 kernel), greedy decode to the
    backend's token caps.  Returns (encode, decode, max_tokens)."""
    from moonshine_tpu_torch.decoding.greedy import greedy_decode
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.pipeline.backends import OfflineBackend

    model = mm.init_params(cfg, torch.Generator().manual_seed(0)).to("cuda")
    backend = OfflineBackend(model, cfg, tokenizer=None)
    n_real = int(seconds * SAMPLE_RATE)
    n_bucket = backend._bucket_samples(n_real)
    audio = torch.zeros(1, n_bucket)
    audio[0, :n_real] = torch.randn(n_real, generator=torch.Generator().manual_seed(1)) * 0.1
    audio, lengths = audio.cuda(), torch.tensor([n_real], device="cuda")
    rate = backend.max_tokens_per_second
    max_tokens = max(int(n_bucket / SAMPLE_RATE * rate), 8)
    caps = torch.tensor([max(int(seconds * rate), 1)])

    def encode():
        return mm.encode(model, cfg, audio, lengths, attn_impl="auto")

    def decode(memory, mask):
        return greedy_decode(model, cfg, memory, mask, max_tokens=max_tokens, token_caps=caps)

    return encode, decode, max_tokens


def stream_workload(seconds: float = 10.0, chunk_s: float = 0.5):
    """One stream of ``chip_smoke.py [streaming]``: ``medium_streaming``
    with random weights (seed 0) behind the pipeline, VAD off, a synthetic
    clip fed in ``chunk_s`` chunks with that update interval.  Returns
    run(), which feeds a fresh stream and stops it."""
    from chip_smoke import synthetic_clip
    from moonshine_tpu_torch.core.config import STREAMING_ARCHS, TranscriberOptions, VadOptions
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.pipeline.backends import StreamingBackend
    from moonshine_tpu_torch.pipeline.transcriber import Transcriber

    cfg = STREAMING_ARCHS["medium_streaming"]
    model = ms.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"w{i}".encode() for i in range(3, cfg.vocab_size)]
    pipeline = Transcriber(StreamingBackend(model, cfg, BinTokenizer(vocab)),
                           TranscriberOptions(vad=VadOptions(threshold=0.0)))
    clip = synthetic_clip(seconds, 12)
    n = int(chunk_s * SAMPLE_RATE)

    def run():
        stream = pipeline.create_stream(update_interval=chunk_s)
        stream.start()
        for i in range(0, len(clip), n):
            stream.add_audio(clip[i:i + n])
        stream.stop()
        pipeline.free_stream(stream)

    return run


def trace_stream() -> None:
    """The ``streaming`` mode: one warm-up stream, then one traced."""
    run = stream_workload()
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, rows = device_us(prof)
    print(f"[stream] medium_streaming, 10 s in 0.5 s chunks: wall {wall_us / 1e3:.3f} ms, "
          f"kernels {busy / 1e3:.3f} ms, device idle share {1 - busy / wall_us:.3f}, "
          f"{sum(e.count for e in rows)} kernel launches")
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out",
                                          "torch_profile_streaming_trace.json.gz"))


def trace_serving() -> None:
    """The ``serving`` mode: one cohort of chip_smoke.py [serving]."""
    from chip_smoke import SERVING_COHORTS, SERVING_KW, SERVING_STREAMS, serving_workload
    from moonshine_tpu_torch.models import streaming_batch as sb

    per = SERVING_STREAMS // SERVING_COHORTS
    svc, feed, _ = serving_workload(per, 1)
    step = SERVING_KW["update_frames"] * 80

    def tick(decode: bool = True):
        for i in range(per):
            feed(i, step)
        return svc.update(decode_tick=decode)

    for _ in range(3):
        tick()
    calls = [0]
    inner = sb._decode_step_batch

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    sb._decode_step_batch = counted
    launches = {}
    for name, decode in (("decoding update", True), ("ingest-only update", False)):
        calls[0] = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tick(decode)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, rows = device_us(prof)
        launches[name] = sum(e.count for e in rows)
        copies = sum(e.self_device_time_total for e in rows if "direct_copy" in e.key)
        print(f"[{name}] medium_streaming, {per} streams, bf16, int8 KV: wall "
              f"{wall_us / 1e3:.3f} ms, kernels {busy / 1e3:.3f} ms, device idle share "
              f"{1 - busy / wall_us:.3f}, {launches[name]} kernel launches, {calls[0]} decoder "
              f"calls; dtype copies {copies / 1e3:.3f} ms ({copies / max(busy, 1):.1%} of device "
              "time)")
        for e in rows[:12]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
        if decode:
            decoder_calls = calls[0]
            os.makedirs("chiprun_out", exist_ok=True)
            prof.export_chrome_trace(os.path.join("chiprun_out",
                                                  "torch_profile_serving_trace.json.gz"))
    sb._decode_step_batch = inner
    print(f"[serving] launches a decoder call (the decoding update's beyond the ingest-only "
          f"one's): {(launches['decoding update'] - launches['ingest-only update']) / max(decoder_calls, 1):.1f}")


def trace_diarizer() -> None:
    """The ``diarizer`` mode: one analysis step of a SpeakerDiarizer over
    the segmentation and embedding models on the card."""
    from chip_smoke import two_speaker_conversation
    from moonshine_tpu_torch.models import diarization as dm
    from moonshine_tpu_torch.pipeline.diarization import SpeakerDiarizer

    seg = dm.init_segmentation_params(torch.Generator().manual_seed(2), device="cuda")
    emb = dm.init_embedding_params(torch.Generator().manual_seed(3), device="cuda")
    calls = []

    def activities(batch):
        calls.append(("segmentation_activations", len(batch)))
        return dm.segmentation_activations(seg, torch.from_numpy(batch).cuda()).cpu().numpy()

    def embeddings(batch, weights):
        calls.append(("embedding_forward", len(batch)))
        return dm.embedding_forward(emb, torch.from_numpy(batch).cuda(),
                                    torch.from_numpy(weights).cuda()).cpu().numpy()

    diarizer = SpeakerDiarizer(activities, embeddings)
    audio, _ = two_speaker_conversation()
    sid, piece = diarizer.create_stream(), 2 * SAMPLE_RATE
    for i in range(0, 30 * SAMPLE_RATE, piece):
        diarizer.add_audio(sid, audio[i:i + piece])
    calls.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        diarizer.add_audio(sid, audio[30 * SAMPLE_RATE:32 * SAMPLE_RATE])
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, rows = device_us(prof)
    print(f"[diarizer] one analysis step after 30 s, model calls {calls}: wall "
          f"{wall_us / 1e3:.3f} ms, kernels {busy / 1e3:.3f} ms, device idle share "
          f"{1 - busy / wall_us:.3f}, {sum(e.count for e in rows)} kernel launches")
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "torch_profile_diarizer_trace.json.gz"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", choices=("greedy", "w8a8", "beam", "speculative", "transcriber",
                                         "streaming", "serving", "diarizer"), default="greedy")
    ap.add_argument("--batch", type=int, default=None,
                    help="utterances (default 64 for greedy and w8a8, 128 for beam, 32 for "
                         "speculative; transcriber and streaming take 1; serving takes "
                         "one cohort of 32 streams; diarizer takes what its step gives)")
    args = ap.parse_args()
    resolve_device()  # raises without CUDA
    args.batch = args.batch or {"greedy": 64, "w8a8": 64, "beam": 128, "speculative": 32,
                                "transcriber": 1, "streaming": 1, "serving": 32,
                                "diarizer": 1}[args.decode]
    if args.decode == "diarizer":
        trace_diarizer()
        print(torch.cuda.get_device_name(0))
        return 0
    if args.decode == "serving":
        if args.batch != 32:
            ap.error("the serving workload is one cohort of 32 streams")
        trace_serving()
        print(torch.cuda.get_device_name(0))
        return 0
    if args.decode == "streaming":
        if args.batch != 1:
            ap.error("the streaming workload is one stream")
        trace_stream()
        print(torch.cuda.get_device_name(0))
        return 0
    if args.decode == "transcriber":
        if args.batch != 1:
            ap.error("the transcriber workload is one segment")
        encode, decode, max_tokens = segment_workload(BASE)
    elif args.decode == "speculative":
        encode, decode, max_tokens = speculative_workload(BASE, TINY, args.batch)
    elif args.decode == "beam":
        encode, decode, max_tokens = beam_workload(BASE, args.batch)
    else:
        encode, decode, max_tokens = batched_workload(BASE, args.batch,
                                                      w8a8=args.decode == "w8a8")

    with torch.inference_mode():
        memories = encode()
        decode(*memories)
        torch.cuda.synchronize()
        os.makedirs("chiprun_out", exist_ok=True)
        for name, fn in (("encode", encode), ("decode", lambda: decode(*memories))):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy, rows = device_us(prof)
            steps = f", {max_tokens} tokens" if name == "decode" else ""
            print(f"[{name}] {args.decode} B={args.batch}{steps}: wall {wall_us / 1e3:.3f} ms, "
                  f"kernels {busy / 1e3:.3f} ms, device idle share {1 - busy / wall_us:.3f}, "
                  f"{sum(e.count for e in rows)} kernel launches")
            # The top items, then the port's own kernels wherever they rank.
            ours = [e for e in rows[12:] if any(k in e.key for k in OWN_KERNELS)]
            for e in rows[:12] + ours:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
            if name == "decode":
                prof.export_chrome_trace(os.path.join(
                    "chiprun_out", f"torch_profile_{args.decode}_trace.json.gz"))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
