#!/usr/bin/env python3
"""Device time of the float32 encoder attention (K1, K2) of two checkouts
of this repository, timed in one run on one CUDA card.

    python3 scripts/compare_f32_attention.py OLD NEW [--out chiprun_out/f32_compare.json]

OLD and NEW are the roots of two checkouts (for a change and its parent,
``git archive`` the parent into a directory that .gitignore lists).  Both
build their encoder-attention library at once; then each is timed in a
process of its own, in the order OLD, NEW, NEW, OLD, by this checkout's
``chip_smoke.phase_f32_times``: K1 at the Transcriber's 2, 16 and 64 s
buckets and K2 at the 16 s one, one segment, a quarter of it padding; the
card spins before each timed call, so the device alone is timed, and each
kernel's output is held against its plain version.  Prints the card, one
line per shape with the kernel's four medians and OLD's mean over NEW's,
and the JSON record as the last line (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (it imports torch and
    numpy only when imported)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _encoder_attention(root: str):
    """The encoder-attention module of the checkout at ``root``."""
    sys.path.insert(0, root)
    from moonshine_tpu_torch.ops import _build
    from moonshine_tpu_torch.ops import encoder_attention as ea

    if not os.path.realpath(ea.__file__).startswith(os.path.realpath(root) + os.sep):
        raise SystemExit(f"imported {ea.__file__}, not the checkout at {root}")
    return _build, ea


def run_one(root: str) -> int:
    """Time the checkout at ``root``; the last line of output is the JSON
    of phase_f32_times."""
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device; none is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, ea = _encoder_attention(root)
    times = _chip_smoke().phase_f32_times(ea)
    print(json.dumps(times), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", metavar="ROOT", help="OLD and NEW checkout roots")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "f32_compare.json"))
    ap.add_argument("--one", help=argparse.SUPPRESS)    # child: time this root
    ap.add_argument("--build", help=argparse.SUPPRESS)  # child: build this root's library
    args = ap.parse_args()
    if args.one:
        return run_one(os.path.abspath(args.one))
    if args.build:
        _build, _ = _encoder_attention(os.path.abspath(args.build))
        print(_build.build(("encoder_attention",))["encoder_attention"], flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkout roots, OLD and NEW")
    old, new = (os.path.abspath(r) for r in args.roots)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r]) for r in (old, new)]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a build failed")
    card = _chip_smoke().card_line()
    print(card, flush=True)
    runs = []
    for label, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        print(f"[{label}] {root}", flush=True)
        res = subprocess.run([sys.executable, me, "--one", root], stdout=subprocess.PIPE,
                             text=True, timeout=600)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            raise SystemExit(f"timing {root} failed with exit code {res.returncode}")
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    summary = {}
    for case in runs[0][1]:
        ms = {label: [r[case]["kernel_ms"] for lab, r in runs if lab == label]
              for label in ("old", "new")}
        order = [r[case]["kernel_ms"] for _, r in runs]
        summary[case] = {"shape": runs[0][1][case]["shape"], "kernel_ms_in_order": order,
                         "library_ms_in_order": [r[case]["library_ms"] for _, r in runs],
                         "old_over_new": statistics.mean(ms["old"]) / statistics.mean(ms["new"])}
        print(f"{case} {summary[case]['shape']}: kernel ms old, new, new, old = "
              + ", ".join(f"{x:.4f}" for x in order)
              + f"; old / new {summary[case]['old_over_new']:.3f}", flush=True)
    record = {"card": card, "old": old, "new": new, "order": [lab for lab, _ in runs],
              "summary": summary, "runs": [r for _, r in runs]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"card": card, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
