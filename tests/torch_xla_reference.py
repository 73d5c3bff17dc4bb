"""JAX references computed with a single-threaded XLA CPU client.

XLA's CPU client splits a float32 product over several threads, and the
order in which it then sums depends on how many threads the host gives it.
For a float comparison that moves the last bit and nothing else.  Where
the KV caches are int8, ``quantize_kv`` turns such a last-bit difference
into a whole int8 step whenever a value sits at a rounding tie, and a
score or a token of the JAX reference then changes with the host.  So the
port's tests compute their int8-KV references here: in one subprocess per
test module, whose XLA CPU client runs single-threaded, which makes the
reference the same on every host.

    refs = single_threaded(__file__, "int8_references", inputs, tmp_dir)

runs ``int8_references(inputs)`` of the calling test module (its path is
``__file__``) in the subprocess; ``inputs`` and the returned value are
flat dicts of numpy arrays, passed through ``.npz`` files in ``tmp_dir``.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np

# Eigen's products on one thread, and one thread for XLA's own operations.
XLA_SINGLE_THREAD = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
REPO = pathlib.Path(__file__).resolve().parents[1]


def single_threaded(module_file: str, function: str, inputs: dict[str, np.ndarray],
                    tmp_dir, timeout: float = 600) -> dict[str, np.ndarray]:
    """``function(inputs)`` of the module at ``module_file``, run in a
    subprocess with a single-threaded XLA CPU client."""
    tmp_dir = pathlib.Path(tmp_dir)
    in_path, out_path = tmp_dir / f"{function}_in.npz", tmp_dir / f"{function}_out.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ, XLA_FLAGS=XLA_SINGLE_THREAD, JAX_PLATFORMS="cpu",
               # An executable cached by a multi-threaded run is not reused.
               MOONSHINE_TPU_COMPILE_CACHE="off",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, __file__, str(module_file), function, str(in_path), str(out_path)],
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{function} failed in the single-threaded XLA process:\n"
                           f"{proc.stderr[-4000:]}")
    with np.load(out_path) as f:
        return {k: f[k] for k in f.files}


def _main(module_file: str, function: str, in_path: str, out_path: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location("_reference_module", module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with np.load(in_path) as f:
        inputs = {k: f[k] for k in f.files}
    out = getattr(module, function)(inputs)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _main(*sys.argv[1:5])
