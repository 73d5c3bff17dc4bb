"""Test set-up of the benchmark's own tests (``benchmark/tests``): the
harness and the repository on the path, and the ``cuda`` marker for the
tests that need a card (each decides inside itself and skips here)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason where there is none")
