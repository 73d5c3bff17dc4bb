"""Finding a cell's files by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each cell,
configuration, traffic mix and per-layer metric has a file of its own under
``benchmark/``.  Nothing here knows any particular cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """One entry of ``workloads``: its files read and its metrics chosen."""

    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    precision: dict
    limits: dict  # number compared -> its limit
    end_to_end: list  # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list  # BENCHMARK.json's per_layer entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with the files it names.
    Raises ``KeyError`` for a cell the benchmark does not list and
    ``ValueError`` where the cell's file disagrees with the listing."""
    spec = benchmark_spec() if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json lists no cell {name!r}")
    cell_file = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell_file[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key}={cell_file[key]!r}, "
                             f"BENCHMARK.json says {entry[key]!r}")
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name, chips=entry["chips"], config=config, traffic=traffic,
        precision=cell_file["precision"], limits=cell_file.get("limits", {}),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    """The driver module ``portbench.drivers.<name>`` a traffic mix names."""
    return importlib.import_module(f"portbench.drivers.{name}")
