"""Streaming latency benchmark — mirror of the reference ``benchmark``.

Counterpart of the JAX package's ``eval/latency.py``, over the port's
``Transcriber`` (any object with ``create_stream``: the ``api`` or the
pipeline ``Transcriber``).

Feeds a WAV in ~21 ms chunks through a live stream and reports (a) compute
as % of audio duration (inverse RTF) and (b) average post-phrase latency
over completed lines via ``last_transcription_latency_ms`` — the same two
numbers the reference binary prints (reference: core/benchmark.cpp:13-16,
94-105; README.md:1064-1068).
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..audio.wav import load_wav

CHUNK_SECONDS = 0.021  # ~21 ms, reference: benchmark.cpp:13


def run_latency_bench(
    transcriber,
    wav_path: str,
    update_interval: float = 0.5,
    realtime: bool = False,
) -> dict:
    """Stream ``wav_path`` through ``transcriber`` and measure latency."""
    audio, sr = load_wav(wav_path)
    chunk = max(int(sr * CHUNK_SECONDS), 1)
    stream = transcriber.create_stream(update_interval=update_interval)
    stream.start()

    compute_seconds = 0.0
    t_start = time.perf_counter()
    for i in range(0, len(audio), chunk):
        t0 = time.perf_counter()
        stream.add_audio(audio[i : i + chunk], sr)
        compute_seconds += time.perf_counter() - t0
        if realtime:
            time.sleep(max(0.0, CHUNK_SECONDS - (time.perf_counter() - t0)))
    t0 = time.perf_counter()
    transcript = stream.stop()
    compute_seconds += time.perf_counter() - t0
    wall = time.perf_counter() - t_start

    latencies = [
        l.last_transcription_latency_ms
        for l in transcript.lines
        if l.is_complete
    ]
    duration = len(audio) / sr
    return {
        "audio_seconds": duration,
        "compute_seconds": compute_seconds,
        "compute_percent_of_audio": 100.0 * compute_seconds / max(duration, 1e-9),
        "avg_post_phrase_latency_ms": float(np.mean(latencies)) if latencies else 0.0,
        "completed_lines": len(latencies),
        "wall_seconds": wall,
        "text": transcript.text,
    }


def main(argv=None) -> None:  # pragma: no cover - exercised via CLI
    import argparse

    from ..api import Transcriber
    from ..core.config import TranscriberOptions, VadOptions

    p = argparse.ArgumentParser()
    p.add_argument("wav")
    p.add_argument("--model", default="tiny_streaming")
    p.add_argument("--weights", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--update-interval", type=float, default=0.5)
    p.add_argument("--vad-threshold", type=float, default=0.5)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    t = Transcriber(
        model=args.model,
        weights=args.weights,
        tokenizer_path=args.tokenizer,
        options=TranscriberOptions(vad=VadOptions(threshold=args.vad_threshold)),
        device=args.device,
    ).load()
    out = run_latency_bench(t, args.wav, args.update_interval)
    out.pop("text")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
