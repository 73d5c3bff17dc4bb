"""The port stands alone: it imports neither JAX nor the JAX package, runs
on CUDA unless told otherwise, and needs ``nvcc`` only to build a kernel."""

from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "moonshine_tpu_torch"


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['moonshine_tpu'] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'moonshine_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_no_source_names_jax(path):
    text = (REPO / path).read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "moonshine_tpu." not in text.replace("moonshine_tpu_torch.", "")


def _runtime_sources() -> list[str]:
    """The port's copies of the native runtime and the platform bindings
    (what a build writes under ``build/`` is not a source)."""
    root = PORT / "runtime"
    return sorted(p.relative_to(root).as_posix()
                  for d in ("native", "bindings") for p in (root / d).rglob("*")
                  if p.is_file() and "build" not in p.relative_to(root).parts)


@pytest.mark.parametrize("path", _runtime_sources())
def test_runtime_copy_matches_the_reference(path):
    """Each C/C++, Java, Swift and TypeScript file of the port's runtime has
    the bytes of the JAX package's, so a fix to one copy cannot miss the
    other; a deliberate divergence changes this test and ROADMAP queue 3."""
    ours = PORT / "runtime" / path
    theirs = REPO / "moonshine_tpu" / "runtime" / path
    assert theirs.is_file(), f"the reference has no {path}"
    assert ours.read_bytes() == theirs.read_bytes()


def test_default_device_without_cuda_raises(monkeypatch):
    from moonshine_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_transcriber_default_device_without_cuda_raises(monkeypatch, tmp_path):
    from moonshine_tpu_torch import Transcriber

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcriber(model="tiny", tokenizer_path=tmp_path / "none.bin").load()


def test_kernel_module_imports_without_nvcc_and_build_needs_it(monkeypatch):
    from moonshine_tpu_torch.ops import _build, encoder_attention  # noqa: F401

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", pathlib.Path("/nonexistent/build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("encoder_attention")


def test_kernel_sources_are_named_by_the_build():
    from moonshine_tpu_torch.ops import _build

    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
