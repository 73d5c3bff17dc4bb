"""Serving: 95th percentile of the wall of a cohort update (see
update_ms_p50.serve)."""

from portbench.readers import percentile_ms


def read(record):
    return percentile_ms(record, "update", 95)
