"""Run one cell of BENCHMARK.json once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures moonshine_tpu_torch on the CUDA devices of this machine; exits
with a non-zero code and prints no result where there are fewer than the
cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One host thread for the CPU's arithmetic: the program's work is on the
# card, and idle pool threads that spin only compete with the thread that
# launches it.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from portbench.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
