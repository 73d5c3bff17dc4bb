"""What a benchmark run loads: no module whose top-level name (the part
before the first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``moonshine_tpu`` (``moonshine_tpu_torch`` is another name); and the plain
reference loads nothing of ``moonshine_tpu_torch``.  Each check runs in a
fresh interpreter, so that nothing this test process loaded counts."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
from portbench import spec

BENCH = spec.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "moonshine_tpu"}


def _top_levels_after(code: str) -> set[str]:
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_and_no_jax_package():
    mods = ["portbench.runner", "portbench.spec"] + [
        f"portbench.drivers.{p.stem}" for p in (BENCH / "portbench" / "drivers").glob("*.py")
        if p.stem != "__init__"]
    readers = [p.stem for p in (BENCH / "metrics").glob("*.py")]
    cells = [p.stem for p in (BENCH / "workloads").glob("*.json")]
    code = "\n".join(
        [f"import {m}" for m in mods]
        + ["from portbench import spec",
           f"[spec.metric_reader(m) for m in {readers!r}]",
           f"cells = [spec.load_cell(c) for c in {cells!r}]",
           "import moonshine_tpu_torch.serving, moonshine_tpu_torch.api",
           "import moonshine_tpu_torch.decoding.greedy, moonshine_tpu_torch.models.streaming_batch",
           "import reference.moonshine, reference.streaming"])
    loaded = _top_levels_after(code)
    assert "moonshine_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_levels_after("import reference.moonshine, reference.streaming, "
                               "reference.numerics")
    assert "moonshine_tpu_torch" not in loaded and not loaded & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_no_reference_source_names_the_program(path: Path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in FORBIDDEN | {"moonshine_tpu_torch"}]


def test_run_refuses_without_a_card(tmp_path):
    """A run on a machine without CUDA exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "base_offline_b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
