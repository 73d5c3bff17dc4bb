"""Model: the LLM's prefill at its roofline: the least time of the traced
batch's prompts (each clip alone at its own prompt length: the layers'
products and causal attention at 989 TFLOP/s, against the weights read and
the prompts' K/V written once at 3.35 TB/s; portbench/flops_salm.py) over
the device time of the operations launched inside the program's
``salm.prefill`` spans of the traced decode.  It counts the same work
whatever implements it."""

from portbench.flops_salm import prefill_bound
from portbench.launches import launched_within_s, span_intervals_us


def read(record):
    sessions = [s for s in record.sessions if "salm" in s.info]
    inside = launched_within_s(sessions, span_intervals_us("salm.prefill"))
    if not sessions or inside is None:
        return None
    bound = sum(prefill_bound(s.info["salm"]["arch"], s.info["salm"]["prompt_lengths"],
                              s.info["salm"]["elt_bytes"])["bound_s"] for s in sessions)
    return 100.0 * bound / inside
