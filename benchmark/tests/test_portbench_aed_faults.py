"""The Canary cell (``canary_1b_flash_longform_b128``) in a tiny form, driven
through whole runs on the CPU: a sound run is correct, and each fault the
cell can have makes it incorrect: the relative-position term dropped from
every encoder attention or misaligned by one position, a decoder cache
that never advances, a token altered where greedy_decode makes it; the
control (the reference one precision lower) fails a limit; the traced
work is the same for every seed.

The tiny form: 2 + 2 layers of width 64 (4 heads), 16 stem channels, a
vocabulary of 300, 24 clips of 1-6 s in 1 s buckets, 8 a batch; the
cell's traffic otherwise.  In bf16 it keeps the cell's limits, and the
position term's faults show in ``relpos_probe_rel_err`` (the attention
probe: aed_offline.POS_PROBE_SCALE).  The float32 form holds the memory
and the probe to 3e-5 and the logits to 2e-4: the program's largest
readings are 1e-6, 1e-6 and 9.2e-5, the TF32 control's smallest 4.3e-4,
6.1e-4 and 3.8e-4, and each limit lies near the geometric mean of its
two, as the cell's limits are set.
"""

import time

import pytest
import torch
from portbench import runner, spec, traffic
from portbench.drivers import aed_offline
from portbench.drivers.offline_batch import traced_clips

CELL = "canary_1b_flash_longform_b128"
TINY_ARCH = dict(d_model=64, encoder_layers=2, decoder_layers=2, n_heads=4, ff_dim=128,
                 subsampling_channels=16, vocab_size=300, max_positions=256)
FLOAT32_LIMITS = dict(memory_rel_err=3e-5, logit_rel_err=2e-4, relpos_probe_rel_err=3e-5)
SECONDS = 2.0


def tiny_cell(weights: str = "bfloat16") -> spec.Cell:
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, arch=dict(cell.config["arch"], **TINY_ARCH))
    mix = cell.traffic
    cell.traffic = dict(mix, clips=dict(mix["clips"], pool=24, median_s=3.0, min_s=1.0, max_s=6.0),
                        batch=8, bucket_samples=16000, max_bucket_samples=96000, check_clips=6,
                        check_memories=3)
    if weights == "float32":
        cell.precision = dict(cell.precision, weights="float32")
        cell.limits = dict(cell.limits, **FLOAT32_LIMITS)
    return cell


def run_tiny(seed: int = 20261018, trace: bool = False, weights: str = "bfloat16") -> dict:
    return runner.run_cell(tiny_cell(weights), seed, SECONDS, trace, "cpu", time.perf_counter())


def _position_term_dropped(monkeypatch):
    from moonshine_tpu_torch.models import canary

    real = canary.rel_shift_view
    monkeypatch.setattr(canary, "rel_shift_view", lambda bd, b, t: real(bd * 0, b, t))


def _position_term_misaligned(monkeypatch):
    from moonshine_tpu_torch.models import canary

    real = canary.rel_shift_view
    monkeypatch.setattr(canary, "rel_shift_view",
                        lambda bd, b, t: real(bd.roll(1, dims=-1), b, t))


def _cache_stuck(monkeypatch):
    from moonshine_tpu_torch.models import canary

    real = canary.decoder_apply

    def stuck(p, cfg, tokens, cache, *args, **kw):
        logits, new, w = real(p, cfg, tokens, cache, *args, **kw)
        return logits, new._replace(cur_len=cache.cur_len), w

    monkeypatch.setattr(canary, "decoder_apply", stuck)


def _token_altered(monkeypatch):
    from moonshine_tpu_torch.decoding import greedy

    real = greedy.greedy_decode

    def altered(model, cfg, *args, **kw):
        res = real(model, cfg, *args, **kw)
        tokens = res.tokens.clone()
        tokens[:, 1] = (tokens[:, 1] + 1) % cfg.vocab_size
        return res._replace(tokens=tokens)

    monkeypatch.setattr(greedy, "greedy_decode", altered)


# fault -> (its form's weights, the fault)
FAULTS = {"position term dropped": ("bfloat16", _position_term_dropped),
          "position term dropped, float32": ("float32", _position_term_dropped),
          "position term misaligned": ("bfloat16", _position_term_misaligned),
          "cache never advances": ("bfloat16", _cache_stuck),
          "token altered": ("bfloat16", _token_altered)}


@pytest.mark.parametrize("weights", ["bfloat16", "float32"])
def test_a_sound_run_is_correct(weights):
    out = run_tiny(weights=weights)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"logit_gap", "memory_rel_err", "logit_rel_err",
                                  "relpos_probe_rel_err"}
    # No device operation is traced on the CPU: the device-trace metric is
    # left out, the host-clock one reported.
    assert set(out["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    weights, make = FAULTS[fault]
    make(monkeypatch)
    out = run_tiny(weights=weights)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("weights", ["bfloat16", "float32"])
def test_the_control_fails_the_limit(weights):
    """The reference one precision below the form's (fp8 under bf16, TF32
    under float32) in the program's place: one of its numbers lies above
    the form's limit."""
    c = tiny_cell(weights)
    drv = spec.driver(c.traffic["driver"])
    ctx = runner.Context(c, 31, torch.device("cpu"), runner.RunRecord(c.name, c.precision))
    drv.setup(ctx)
    drv.window(ctx, SECONDS)
    drv.release(ctx)
    numbers = drv.control(ctx, "fp8" if weights == "bfloat16" else "tf32")
    assert any(numbers[k] > limit for k, limit in c.limits.items()), (numbers, c.limits)


def test_a_traced_run_reports_the_host_metrics():
    out = run_tiny(trace=True)
    names = {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert set(out["metrics"]) <= names
    assert {"decode_ms_per_step.offline", "encode_ms_per_batch.offline", "audio_s_per_s.offline",
            "host_work_share.offline"} <= set(out["metrics"])
    assert out["device"]["busy_s"] == 0 and out["breakdown"]["device_ops"] == []


def test_the_traced_work_is_the_same_for_every_seed():
    c = tiny_cell()
    drv = spec.driver(c.traffic["driver"])
    seen = []
    for seed, seconds in ((5, 0.5), (2**31 + 7, 2.0)):
        ctx = runner.Context(c, seed, torch.device("cpu"), runner.RunRecord(c.name, c.precision))
        drv.setup(ctx)
        drv.window(ctx, seconds)
        drv.trace(ctx, host=False)
        drv.release(ctx)
        seen.append((ctx.record.counters["traced_audio_s"], len(ctx.record.sessions)))
    assert seen[0] == seen[1] and seen[0][0] > 0


def test_the_full_traffic_traces_a_full_batch_of_one_bucket():
    """At the cell's own traffic: 4,096 clips of 10-40 s in 5.12 s buckets;
    the traced batch is 128 clips of the bucket with the most batches, the
    same lengths for every seed."""
    mix = spec.load_cell(CELL).traffic
    lengths = traffic.clip_lengths(mix["clips"])
    assert lengths.min() == 160000 and lengths.max() == 640000 and len(lengths) == 4096
    picked = []
    for seed in (3, 2**31 + 11):
        order = traffic.rng(seed, 3).permutation(len(lengths))
        batches = aed_offline.bucket_batches(lengths, order, mix["batch"], mix["bucket_samples"],
                                             mix["max_bucket_samples"])
        assert {n for n, _ in batches} <= {81920 * k for k in range(2, 9)}
        assert all(len(idx) <= 128 and (lengths[idx] <= n).all() for n, idx in batches)
        plans = [{"n": n, "idx": idx} for n, idx in traffic.interleave(batches, seed)]
        (idx,) = traced_clips(plans, lengths, mix["batch"], 1)
        (n,) = {p["n"] for p in plans if set(idx.tolist()) & set(p["idx"].tolist())}
        picked.append((n, sorted(lengths[idx].tolist())))
    assert picked[0] == picked[1] and len(picked[0][1]) == 128
