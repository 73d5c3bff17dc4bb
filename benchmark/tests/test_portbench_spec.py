"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, driver and metric readers exist and agree, and the file keeps
to the benchmark contract's shape."""

import json
import re

import pytest
from portbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_files_exist_and_agree(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert (spec.BENCH_DIR / "portbench" / "drivers" / f"{cell.traffic['driver']}.py").exists()
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert entry["file"] == f"benchmark/configs/{cell.config['name']}.json"
    assert entry["source"] == cell.config["source"]
    assert cell.precision["weights"] in ("bfloat16", "float32")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    # Every cell reports set-up, another end-to-end metric and a per-layer one.
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {name} does not report"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    read = spec.metric_reader(metric)
    assert callable(read)


def test_metric_entries_keep_to_the_contract():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m.get("workloads", []):
            assert w in CELL_NAMES
    assert {"kernels", "device", "whole step"} <= set(layers)


def test_every_workload_file_is_listed():
    files = {p.stem for p in (spec.BENCH_DIR / "workloads").glob("*.json")}
    assert files == set(CELL_NAMES)


def test_traced_offline_batch_is_the_same_bucket_for_every_seed():
    """The traced batch does not follow how far the window got: clips of
    the bucket with the most batches, the same lengths for every seed."""
    from portbench import traffic
    from portbench.drivers.offline_batch import traced_clips

    mix = spec.load_json(spec.BENCH_DIR / "traffic" / "offline_corpus_b64.json")
    arch = spec.load_json(spec.BENCH_DIR / "configs" / "moonshine_base.json")["arch"]
    lengths = traffic.clip_lengths(mix["clips"])
    picked = []
    for seed in (3, 2**31 + 11):
        order = traffic.rng(seed, 3).permutation(len(lengths))
        batches = traffic.interleave(traffic.bucket_batches(arch, lengths, order, mix["batch"]),
                                     seed)
        plans = [{"n": n, "idx": idx} for n, idx in batches]
        (idx,) = traced_clips(plans, lengths, mix["batch"], 1)
        assert len(idx) == mix["batch"] == len(set(idx.tolist()))
        (n,) = {plan["n"] for plan in plans if set(idx.tolist()) & set(plan["idx"].tolist())}
        picked.append((n, sorted(lengths[idx].tolist())))
    assert picked[0] == picked[1]


def test_the_device_time_readers():
    """The end-to-end metrics of source device_trace: the union of the
    traced operations' intervals per second of the traced audio, and the
    traced work's FLOPs over that time times the peak."""
    from portbench import readers, runner
    from portbench.trace import Session

    record = runner.RunRecord("x", {})
    assert readers.device_ms_per_audio_s(record) is None and readers.mfu_percent(record) is None
    ops = [("a", 0.0, 300.0), ("b", 200.0, 500.0), ("c", 1000.0, 1500.0)]  # microseconds
    record.sessions.append(Session("t", 0.01, ops))
    record.counters.update(traced_audio_s=2.0, traced_model_flops=1e9, peak_flops=1e15)
    assert readers.device_ms_per_audio_s(record) == pytest.approx(1.0 / 2.0)
    assert readers.mfu_percent(record) == pytest.approx(100.0 * 1e9 / (1e-3 * 1e15))
