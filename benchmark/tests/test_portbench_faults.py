"""``correct`` comes out true for a sound run and false for each fault a
cell can have, and for the control: every cell's tiny form driven through
a whole run on the CPU (the look for a card skipped), with the timed path
broken underneath.

The faults: a step that returns its state unchanged; half of the batch
left out, the mean of the rest in its place; a token altered where it is
produced.  No cell runs on more than one chip, so none can leave out an
exchange between chips.
"""

import pytest
import torch
from portbench import runner, spec
from tiny import CELLS, TINY_SECONDS, run_tiny, tiny_cell


def _decoder_stuck(monkeypatch):
    """Each decoder call returns the cache at its old position."""
    from moonshine_tpu_torch.models import moonshine as mm

    orig = mm.decoder_apply

    def stuck(p, cfg, tokens, cache, *args, **kw):
        logits, new, w = orig(p, cfg, tokens, cache, *args, **kw)
        return logits, new._replace(cur_len=cache.cur_len), w

    monkeypatch.setattr(mm, "decoder_apply", stuck)


def _encode_half(monkeypatch):
    """The second half of a batch's memory is the mean of the first's."""
    from moonshine_tpu_torch.models import moonshine as mm

    orig = mm.encode

    def half(*args, **kw):
        memory, mask = orig(*args, **kw)
        keep = max(memory.shape[0] // 2, 1)
        memory = memory.clone()
        memory[keep:] = memory[:keep].mean(0, keepdim=True)
        return memory, mask

    monkeypatch.setattr(mm, "encode", half)


def _alter_token(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    out = tokens.clone()
    out[:, 1] = (out[:, 1] + 1) % vocab
    return out


def _greedy_altered(monkeypatch, where):
    """The second token of every row altered where greedy_decode makes it."""
    from moonshine_tpu_torch.decoding import greedy

    orig = greedy.greedy_decode

    def altered(model, cfg, *args, **kw):
        res = orig(model, cfg, *args, **kw)
        return res._replace(tokens=_alter_token(res.tokens, cfg.vocab_size))

    monkeypatch.setattr(where, "greedy_decode", altered)


def _service_stuck(monkeypatch):
    """Each service update hands back the state it was given."""
    from moonshine_tpu_torch.models import streaming_batch as sb

    orig = sb.service_update_meta

    def stuck(model, cfg, state, *args, **kw):
        return orig(model, cfg, state, *args, **kw)._replace(state=state)

    monkeypatch.setattr(sb, "service_update_meta", stuck)


def _service_half(monkeypatch):
    """The second half of each update's streams takes the mean of the
    first half's audio in place of its own."""
    from moonshine_tpu_torch.models import streaming_batch as sb

    orig = sb.service_update_meta

    def half(model, cfg, state, chunk, *args, **kw):
        keep = max(chunk.shape[0] // 2, 1)
        chunk = chunk.clone()
        chunk[keep:] = chunk[:keep].mean(0, keepdim=True)
        return orig(model, cfg, state, chunk, *args, **kw)

    monkeypatch.setattr(sb, "service_update_meta", half)


def _service_altered(monkeypatch):
    """The second token of every stream's hypothesis altered where the
    update makes it."""
    from moonshine_tpu_torch.models import streaming_batch as sb

    orig = sb.service_update_meta

    def altered(model, cfg, *args, **kw):
        out = orig(model, cfg, *args, **kw)
        return sb._with_packed(out._replace(tokens=_alter_token(out.tokens, cfg.vocab_size)))

    monkeypatch.setattr(sb, "service_update_meta", altered)


def _offline_altered(monkeypatch):
    from moonshine_tpu_torch.decoding import greedy

    _greedy_altered(monkeypatch, greedy)


FAULTS = {
    "base_offline_b64": {"state unchanged": _decoder_stuck, "half the batch": _encode_half,
                         "token altered": _offline_altered},
    "medium_streaming_serve64": {"state unchanged": _service_stuck,
                                 "half the batch": _service_half,
                                 "token altered": _service_altered},
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # The profiler records no device operation here: the metrics of
    # source device_trace find nothing to read and are left out.
    e2e = spec.load_cell(cell).end_to_end
    host = {m["name"] for m in e2e if m["source"] == "host_clock"}
    assert host <= set(out["metrics"]) <= {m["name"] for m in e2e}


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    FAULTS[cell][fault](monkeypatch)
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(cell):
    """The reference one precision below the cell's (fp8 under bfloat16,
    TF32 under float32) in the program's place: one of its numbers lies
    above the cell's limit."""
    c = tiny_cell(cell)
    drv = spec.driver(c.traffic["driver"])
    ctx = runner.Context(c, 31, torch.device("cpu"), runner.RunRecord(c.name, c.precision))
    drv.setup(ctx)
    drv.window(ctx, TINY_SECONDS[c.traffic["driver"]])
    drv.release(ctx)
    mode = "fp8" if c.precision["weights"] == "bfloat16" else "tf32"
    numbers = drv.control(ctx, mode)
    assert any(numbers[k] > limit for k, limit in c.limits.items()), (numbers, c.limits)


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read_here():
    """On the CPU the profiler records no device operation: the trace
    readers return nothing and the run still ends with its result."""
    out = run_tiny("base_offline_b64", trace=True)
    names = {m["name"] for m in spec.load_cell("base_offline_b64").per_layer}
    assert set(out["metrics"]) <= names
    assert {"decode_ms_per_step.offline", "encode_ms_per_batch.offline",
            "audio_s_per_s.offline"} <= set(out["metrics"])
    assert out["device"]["busy_s"] == 0 and out["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_work_is_the_same_for_every_seed(cell):
    """The work whose device time the end-to-end metric reads, traced
    after the window, has the same sizes for every seed, however far the
    window got."""
    c = tiny_cell(cell)
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
