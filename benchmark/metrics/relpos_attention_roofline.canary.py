"""Kernels: the encoder's relative-position attention at its roofline: the
least time of its calls (per clip at its valid frames T, 2*H*T^2*dk (AC),
2*H*T*(2T-1)*dk (BD) and 2*H*T^2*dk (P.V) operations at 989 TFLOP/s
against q, k, v, the position term and the output moved once at 3.35
TB/s; portbench/flops_aed.py) over the device time of the operations
launched inside the program's ``canary.relpos_attention`` spans of the
traced encode.  It counts the same work whatever implements it."""

from portbench.flops_aed import relpos_attention_bound
from portbench.launches import launched_within_s, span_intervals_us


def read(record):
    sessions = [s for s in record.sessions if "relpos" in s.info]
    inside = launched_within_s(sessions, span_intervals_us("canary.relpos_attention"))
    if not sessions or inside is None:
        return None
    bound = 0.0
    for s in sessions:
        r = s.info["relpos"]
        bound += r["calls"] * relpos_attention_bound(r["d_model"], r["lengths"],
                                                      r["elt_bytes"])["bound_s"]
    return 100.0 * bound / inside
