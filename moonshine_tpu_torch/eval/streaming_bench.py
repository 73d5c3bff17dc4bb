"""Streaming service benchmark: N live streams on one card, in PyTorch.

Counterpart of the JAX package's ``eval/streaming_bench.py`` (the
reference ``benchmark`` tool's metrics, compute as % of audio duration and
post-phrase latency, generalized to the multi-stream service): every slot
plays the same recording in update-interval chunks from its own offset,
and the run reports

  - the aggregate realtime multiple (streams x audio time / wall time)
  - per-update wall latency p50/p95 (the service's update cadence)
  - post-phrase latency p50 (wall time of the update that finalized a
    segment: the reference's "time from end of phrase to final text")

Weights are random, from ``seed``; random weights decode to the token
budget, so these numbers bound a trained checkpoint's from above.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

# The bench's recording and TinyVadCNN export, in a checkout of the
# reference at ~/reference.
TWO_CITIES = str(Path.home() / "reference" / "test-assets" / "two_cities_16k.wav")
TINYVAD_ONNX = str(Path.home() / "reference" / "micro" / "models" /
                   "tinyvad_cnn_speech_mel.onnx")


def run_bench(
    model: str = "tiny_streaming",
    n_streams: int = 16,
    n_cohorts: int = 1,
    update_seconds: float = 0.5,
    n_updates: int = 40,
    use_vad: bool = False,
    mem_bucket: int = 2048,
    draft_cap: int = 256,
    seed: int = 0,
    audio_path: str = TWO_CITIES,
    warm: bool = True,
    bf16: bool = True,
    vad_path: str = TINYVAD_ONNX,
    device: str | torch.device | None = None,
) -> dict:
    from ..audio.wav import load_wav
    from ..core.config import STREAMING_ARCHS
    from ..core.device import resolve_device
    from ..models import streaming as ms
    from ..serving import ShardedStreamingService, StreamingService

    dev = resolve_device(device)
    cfg = STREAMING_ARCHS[model]
    params = ms.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    vad = None
    if use_vad:
        from ..models.vad import TinyVad

        vad = TinyVad.from_onnx(vad_path, dev)

    update_frames = int(update_seconds * 16000) // 80
    kw = dict(update_frames=update_frames, mem_bucket=mem_bucket, draft_cap=draft_cap,
              vad=vad, compute_dtype=torch.bfloat16 if bf16 else None, device=dev)
    if n_cohorts > 1:
        # Staggered cohorts: each update() ticks one S/K-stream update.
        svc = ShardedStreamingService(params, cfg, tokenizer=None, n_streams=n_streams,
                                      n_cohorts=n_cohorts, **kw)
    else:
        svc = StreamingService(params, cfg, tokenizer=None, n_streams=n_streams, **kw)
    compile_s = svc.warmup() if warm else 0.0

    audio, sr = load_wav(audio_path)
    assert sr == 16000
    doubled = np.concatenate([audio, audio])  # wraparound reads, built once
    step = int(update_seconds * 16000)
    offsets = [int(i * len(audio) / n_streams) for i in range(n_streams)]

    update_ms: list[float] = []
    final_ms: list[float] = []
    n_finals = 0
    t_bench0 = time.monotonic()
    per = n_streams // n_cohorts
    for u in range(n_updates):
        for c in range(n_cohorts):
            for i in range(c * per, (c + 1) * per):
                lo = (offsets[i] + u * step) % len(audio)
                svc.add_audio(i, doubled[lo: lo + step])
            t0 = time.monotonic()
            events = svc.update(cohort=c) if n_cohorts > 1 else svc.update()
            dt = (time.monotonic() - t0) * 1000.0
            update_ms.append(dt)
            for ev in events:
                if ev.is_final:
                    final_ms.append(ev.latency_ms)
                    n_finals += 1
    wall = time.monotonic() - t_bench0

    audio_seconds = n_streams * n_updates * update_seconds
    return {
        "model": model,
        "bf16": bf16,
        "n_streams": n_streams,
        "n_cohorts": n_cohorts,
        "update_seconds": update_seconds,
        "n_updates": n_updates,
        "use_vad": use_vad,
        "compile_s": round(compile_s, 1),
        "update_ms_p50": round(float(np.percentile(update_ms, 50)), 2),
        "update_ms_p95": round(float(np.percentile(update_ms, 95)), 2),
        "update_ms_mean": round(float(np.mean(update_ms)), 2),
        "post_phrase_ms_p50": (
            round(float(np.percentile(final_ms, 50)), 2) if final_ms else None
        ),
        "n_finals": n_finals,
        "aggregate_realtime_x": round(audio_seconds / wall, 1),
        "compute_pct_of_audio": round(100.0 * wall / audio_seconds, 2),
    }


def main() -> None:  # pragma: no cover - CLI
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="tiny_streaming")
    p.add_argument("--streams", type=int, default=16)
    p.add_argument("--cohorts", type=int, default=1)
    p.add_argument("--updates", type=int, default=40)
    p.add_argument("--update-seconds", type=float, default=0.5)
    p.add_argument("--vad", action="store_true")
    p.add_argument("--mem-bucket", type=int, default=2048)
    p.add_argument("--draft-cap", type=int, default=256)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--audio", default=TWO_CITIES)
    p.add_argument("--vad-onnx", default=TINYVAD_ONNX)
    args = p.parse_args()
    out = run_bench(
        model=args.model, n_streams=args.streams, n_cohorts=args.cohorts,
        n_updates=args.updates, update_seconds=args.update_seconds, use_vad=args.vad,
        mem_bucket=args.mem_bucket, draft_cap=args.draft_cap, bf16=not args.f32,
        audio_path=args.audio, vad_path=args.vad_onnx,
    )
    print(json.dumps(out))


if __name__ == "__main__":  # pragma: no cover
    main()
