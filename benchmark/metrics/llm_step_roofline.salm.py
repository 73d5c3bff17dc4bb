"""Decoding: the LLM's decode steps at their roofline: each step's least
time (the bf16 weights of the layers and the tied head read once, each
row's int8 K/V and scales up to its column read once, the new K/V written
once, at 3.35 TB/s; portbench/flops_salm.py), summed over the traced
decode's steps, over the device time of the operations launched inside
the program's ``greedy.step`` spans of that decode."""

from portbench.flops_salm import steps_bound_s
from portbench.launches import launched_within_s, span_intervals_us


def read(record):
    sessions = [s for s in record.sessions if "salm" in s.info]
    inside = launched_within_s(sessions, span_intervals_us("greedy.step"))
    if not sessions or inside is None:
        return None
    bound = sum(steps_bound_s(s.info["salm"]["arch"], s.info["salm"]["prompt_lengths"],
                              s.info["steps"], s.info["salm"]["elt_bytes"]) for s in sessions)
    return 100.0 * bound / inside
