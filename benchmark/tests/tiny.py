"""Small cells for the CPU tests: each of the benchmark's cells with its
configuration narrowed and its traffic shortened, everything else as the
cell's files give it (precision, limits, drivers)."""

from __future__ import annotations

import time

from portbench import runner, spec

TINY_ARCH = {
    "moonshine_base": dict(hidden_size=64, intermediate_size=128, encoder_layers=2,
                           decoder_layers=2, encoder_heads=2, decoder_heads=2,
                           encoder_kv_heads=2, decoder_kv_heads=2, vocab_size=512),
    # depth 10 keeps the service's 16 * depth frames of left context above
    # ENC_WIN - ENC_STEP, where the window's read clamps.
    "moonshine_medium_streaming": dict(encoder_dim=32, decoder_dim=32, depth=10, nheads=2,
                                       head_dim=16, d_model_frontend=32, c1=64, c2=32,
                                       vocab_size=512, max_seq_len=64),
}
TINY_TRAFFIC = {
    "offline_batch": lambda m: dict(m, clips=dict(m["clips"], pool=24, max_s=6.0), batch=8,
                                    check_clips=6, check_memories=3),
    "streaming_service": lambda m: dict(m, streams=4, cohorts=2, mem_bucket=896, draft_cap=32,
                                        max_segment_seconds=3.0, base_audio_s=8.0,
                                        check_hypotheses=6, check_memories=3),
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, arch=dict(cell.config["arch"],
                                              **TINY_ARCH[cell.config["name"]]))
    cell.traffic = TINY_TRAFFIC[cell.traffic["driver"]](cell.traffic)
    return cell


# The service's window holds a segment's end on a slow host too: its
# tiny stagger finalizes the first segment at the fourth update.
TINY_SECONDS = {"offline_batch": 2.0, "streaming_service": 5.0}


def run_tiny(name: str, seed: int = 20261017, trace: bool = False,
             cell: spec.Cell | None = None) -> dict:
    """One run of the tiny form of cell ``name`` on the CPU (the harness's
    look for a card skipped)."""
    cell = tiny_cell(name) if cell is None else cell
    seconds = TINY_SECONDS[cell.traffic["driver"]]
    return runner.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())


CELLS = ["base_offline_b64", "medium_streaming_serve64"]
