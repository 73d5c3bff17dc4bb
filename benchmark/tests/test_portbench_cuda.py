"""On a card: each cell runs once through ``benchmark/run.py`` with a short
window and its trace, and prints a result line that keeps to the contract.
Skips where there is no CUDA device."""

import json
import subprocess
import sys

import pytest
from portbench import spec
from tiny import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", cell,
                          "--seed", "4294967311", "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, timeout=360, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    names = {m["name"] for m in spec.load_cell(cell).per_layer}
    assert set(line["metrics"]) == names
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
