"""The Canary-Qwen cell (``canary_qwen_2_5b_longform_b128``) in a tiny form,
driven through whole runs on the CPU: a sound run is correct, and each
fault the cell can have makes it incorrect: a query head reading the K/V
head ``i % H_kv`` in place of ``i // (H / H_kv)``, the decode steps' rotary
one position ahead, the audio spliced into the prompt one frame off, a
row's left padding counted into its prompt's positions, a cache whose
cursor never advances past the prompt, the encoder's relative-position
term misaligned by one position (Canary's fault, seen by the encoder's
position probe, ``relpos_probe_rel_err``); the control (the reference one
precision lower) fails a limit; the traced work is the same for every
seed.

RoPE is relative: a row's positions shifted all together change nothing,
so each rotary fault here shifts some positions against others (the steps
against the prompt; a row's prompt by its padding, its steps not).

The tiny form: 2 encoder layers of width 64 (4 heads), 16 stem channels,
1 adapter layer, 2 LLM layers of width 64 with 4 query heads over 2 K/V
heads of 16, a vocabulary of 300 (the prompt's ids and EOS within it), 24
clips of 1-6 s in 1 s buckets, 8 a batch; the cell's traffic otherwise.
In bf16 it keeps the cell's limits.  The float32 form holds the audio
embeddings to 3e-5, the logits to 2e-4, the rotary probe's logits to 6e-4
and the encoder's position probe to 3e-5: the program's largest readings
over three seeds are 1.5e-6, 3.3e-5, 6.1e-5 and 1.2e-6, the TF32 control's
smallest 4.0e-4, 8.5e-4, 6.3e-3 and 3.9e-4, and each limit lies near the
geometric mean of its two, as the cell's limits are set.
"""

import time

import pytest
import torch
from portbench import runner, spec, traffic
from portbench.drivers import aed_offline
from portbench.drivers.offline_batch import traced_clips

CELL = "canary_qwen_2_5b_longform_b128"
TINY_ARCH = dict(d_model=64, encoder_layers=2, n_heads=4, ff_dim=128, subsampling_channels=16,
                 adapter_layers=1, llm_hidden_size=64, llm_layers=2, llm_heads=4, llm_kv_heads=2,
                 llm_head_dim=16, llm_intermediate_size=128, vocab_size=300,
                 prompt_prefix_ids=[1, 2, 3, 4, 5, 6, 7, 8, 9],
                 prompt_suffix_ids=[10, 11, 12, 13, 14], eos_token_id=0)
FLOAT32_LIMITS = dict(audio_embed_rel_err=3e-5, logit_rel_err=2e-4, rope_probe_rel_err=6e-4,
                      relpos_probe_rel_err=3e-5)
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


def run_tiny(seed: int = 20261018, trace: bool = False, weights: str = "bfloat16",
             cell: spec.Cell | None = None) -> dict:
    cell = tiny_cell(weights) if cell is None else cell
    return runner.run_cell(cell, seed, SECONDS, trace, "cpu", time.perf_counter())


def _heads_modulo(monkeypatch):
    """q head i reads K/V head i % H_kv, in the prompt's attention and in
    every step's: q's heads permuted so that the grouped attention pairs
    them so."""
    from moonshine_tpu_torch.models import canary_qwen as cq

    def regrouped(real, kv_heads):
        def attend(q, *args):
            h, hk = q.shape[2], kv_heads(*args)
            # q head i sits at j = (i % H_kv) * group + i // H_kv, which reads K/V head i % H_kv.
            j = [(i % hk) * (h // hk) + i // hk for i in range(h)]
            placed = torch.empty_like(q)
            placed[:, :, j] = q
            return real(placed, *args)[:, :, j]

        return attend

    monkeypatch.setattr(cq, "attend_kv", regrouped(cq.attend_kv, lambda kv, *_: kv.k.shape[1]))
    monkeypatch.setattr(cq, "prefill_attention",
                        regrouped(cq.prefill_attention, lambda k, *_: k.shape[2]))


def _rotary_ahead(monkeypatch):
    """The decode steps' positions one ahead of the prompt's."""
    from moonshine_tpu_torch.models import canary_qwen as cq

    real = cq.positions
    monkeypatch.setattr(cq, "positions",
                        lambda cache, s: real(cache, s) + int(cache.cur_len > 0))


def _splice_shifted(monkeypatch):
    """Each row's audio frames spliced one frame late."""
    from moonshine_tpu_torch.models import canary_qwen as cq

    real = cq.prompt_embeds
    monkeypatch.setattr(cq, "prompt_embeds",
                        lambda p, cfg, memory, mask: real(p, cfg, memory.roll(1, dims=1), mask))


def _padding_in_positions(monkeypatch):
    """A row's prompt positions counted from the batch's first column (its
    left padding included), its steps' from its own first column."""
    from moonshine_tpu_torch.models import canary_qwen as cq

    real = cq.positions

    def counted(cache, s):
        own = real(cache, s)
        return own + cache.start[:, None] if cache.cur_len == 0 else own

    monkeypatch.setattr(cq, "positions", counted)


def _cache_stuck(monkeypatch):
    """The cursor advances past the prompt, never past a token."""
    from moonshine_tpu_torch.models import canary_qwen as cq

    real = cq.decoder_apply

    def stuck(p, cfg, inputs, cache, **kw):
        logits, new, w = real(p, cfg, inputs, cache, **kw)
        return logits, (new._replace(cur_len=cache.cur_len) if cache.cur_len else new), w

    monkeypatch.setattr(cq, "decoder_apply", stuck)


def _position_term_misaligned(monkeypatch):
    """Every encoder and adapter attention's position term one position off."""
    from moonshine_tpu_torch.models import canary

    real = canary.rel_shift_view
    monkeypatch.setattr(canary, "rel_shift_view",
                        lambda bd, b, t: real(bd.roll(1, dims=-1), b, t))


FAULTS = {"query heads read K/V head i % H_kv": _heads_modulo,
          "rotary one position ahead": _rotary_ahead,
          "audio spliced one frame off": _splice_shifted,
          "padding counted into positions": _padding_in_positions,
          "cache never advances": _cache_stuck,
          "position term misaligned": _position_term_misaligned}


@pytest.mark.parametrize("weights", ["bfloat16", "float32"])
def test_a_sound_run_is_correct(weights):
    out = run_tiny(weights=weights)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"logit_gap", "audio_embed_rel_err", "logit_rel_err",
                                  "rope_probe_rel_err", "relpos_probe_rel_err"}
    assert set(out["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = run_tiny()
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
        salm = ctx.record.sessions[-1].info["salm"]
        seen.append((ctx.record.counters["traced_audio_s"], len(ctx.record.sessions),
                     sorted(salm["prompt_lengths"])))
    assert seen[0] == seen[1] and seen[0][0] > 0


def test_the_full_traffic_traces_128_prompts_of_the_20_s_bucket():
    """At the cell's own traffic: the traced batch is 128 clips of the
    20.48 s bucket, the same lengths for every seed, whose prompts are 14
    ids around 193 to 257 frames."""
    from portbench import flops_salm

    c = spec.load_cell(CELL)
    mix, arch = c.traffic, c.config["arch"]
    lengths = traffic.clip_lengths(mix["clips"])
    picked = []
    for seed in (3, 2**31 + 11):
        order = traffic.rng(seed, 3).permutation(len(lengths))
        batches = aed_offline.bucket_batches(lengths, order, mix["batch"], mix["bucket_samples"],
                                             mix["max_bucket_samples"])
        plans = [{"n": n, "idx": idx} for n, idx in traffic.interleave(batches, seed)]
        (idx,) = traced_clips(plans, lengths, mix["batch"], 1)
        picked.append(sorted(flops_salm.prompt_length(arch, int(k)) for k in lengths[idx]))
    assert picked[0] == picked[1] and len(picked[0]) == 128
    assert 14 + 193 <= picked[0][0] and picked[0][-1] <= 14 + 257
