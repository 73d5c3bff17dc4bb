#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's batched offline decode.

    python3 scripts/torch_profile.py [--decode greedy|beam] [--batch N]

Profiles the workload of one of ``chip_smoke.py``'s batched phases:
``chip_smoke.batched_workload`` (greedy, the default; batch 64) or
``chip_smoke.beam_workload`` (beam 4; batch 128 utterances, the bench's),
both Moonshine Base, bf16, int8 KV, 9.26 s clips, random weights, decoding
to the full token cap.  After a warm-up it traces one encode and one whole
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

from chip_smoke import batched_workload, beam_workload  # noqa: E402
from moonshine_tpu_torch.core.config import BASE  # noqa: E402
from moonshine_tpu_torch.core.device import resolve_device  # noqa: E402


OWN_KERNELS = ("packed_attention", "gather_rows")  # csrc/*.cu


def device_us(prof) -> tuple[float, list]:
    """Summed kernel time (us) and the top kernels by device time."""
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return sum(e.self_device_time_total for e in rows), rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", choices=("greedy", "beam"), default="greedy")
    ap.add_argument("--batch", type=int, default=None,
                    help="utterances (default 64 for greedy, 128 for beam)")
    args = ap.parse_args()
    resolve_device()  # raises without CUDA
    workload = batched_workload if args.decode == "greedy" else beam_workload
    args.batch = args.batch or (64 if args.decode == "greedy" else 128)
    encode, decode, max_tokens = workload(BASE, args.batch)

    with torch.inference_mode():
        memory, mask = encode()
        decode(memory, mask)
        torch.cuda.synchronize()
        os.makedirs("chiprun_out", exist_ok=True)
        for name, fn in (("encode", encode), ("decode", lambda: decode(memory, mask))):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy, rows = device_us(prof)
            steps = f", {max_tokens} steps" if name == "decode" else ""
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
