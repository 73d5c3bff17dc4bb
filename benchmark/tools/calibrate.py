"""Read a cell's compared numbers and its control's over many seeds, in one
process, to set the cell's limits (``workloads/<cell>.json``).

    python benchmark/tools/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 10

For each seed: the cell's set-up and a window of ``--seconds``, then the
check's numbers (``check``) and the control's (``control``): the plain
reference computed one precision below the cell's (fp8 for bfloat16,
TF32 for float32), its first tokens' gap at the same positions.  One JSON
line per seed on standard output.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from portbench import runner, spec  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    import torch

    from moonshine_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    _build.build()
    cell = spec.load_cell(args.workload)
    drv = spec.driver(cell.traffic["driver"])
    mode = "fp8" if cell.precision["weights"] == "bfloat16" else "tf32"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = runner.Context(cell, seed, torch.device("cuda"), runner.RunRecord(cell.name,
                                                                              cell.precision))
        drv.setup(ctx)
        setup_s = time.perf_counter() - t0
        e2e = drv.window(ctx, args.seconds)
        drv.release(ctx)
        checks = drv.check(ctx)
        control = drv.control(ctx, mode)
        print(json.dumps({"workload": cell.name, "seed": seed, "setup_s": setup_s, **e2e,
                          "counters": ctx.record.counters, "checks": checks,
                          "control": {"mode": mode, **control},
                          "seconds": time.perf_counter() - t0}), flush=True)
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
