#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's batched offline decode.

    python3 scripts/torch_profile.py [--decode greedy|beam|speculative|transcriber] [--batch N]

Profiles the workload of one of ``chip_smoke.py``'s batched phases:
``chip_smoke.batched_workload`` (greedy, the default; batch 64) or
``chip_smoke.beam_workload`` (beam 4; batch 128 utterances, the bench's),
both Moonshine Base, bf16, int8 KV, 9.26 s clips, random weights, decoding
to the full token cap; or ``chip_smoke.speculative_workload`` (the floor:
Base verifier, Tiny draft, gamma 4, float KV, batch 32, the bench's); or
``segment_workload`` (``transcriber``: one segment of the Transcriber's
main path, Base in float32, B=1).  After a warm-up it traces one encode and one whole
decode with ``torch.profiler``
and prints, for each, from that one traced run: its wall time, the summed
device time of its kernels, the device's idle share over the wall time, and
the kernels that take the most device time.  Wall times include the
profiler's own cost on the host.  Needs one CUDA device; the gzipped Chrome
trace of the decode goes to chiprun_out/torch_profile_<decode>_trace.json.gz.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", choices=("greedy", "beam", "speculative", "transcriber"),
                    default="greedy")
    ap.add_argument("--batch", type=int, default=None,
                    help="utterances (default 64 for greedy, 128 for beam, 32 for speculative; "
                         "transcriber takes 1)")
    args = ap.parse_args()
    resolve_device()  # raises without CUDA
    args.batch = args.batch or {"greedy": 64, "beam": 128, "speculative": 32,
                                "transcriber": 1}[args.decode]
    if args.decode == "transcriber":
        if args.batch != 1:
            ap.error("the transcriber workload is one segment")
        encode, decode, max_tokens = segment_workload(BASE)
    elif args.decode == "speculative":
        encode, decode, max_tokens = speculative_workload(BASE, TINY, args.batch)
    else:
        workload = batched_workload if args.decode == "greedy" else beam_workload
        encode, decode, max_tokens = workload(BASE, args.batch)

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
