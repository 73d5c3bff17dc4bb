"""Serving: median wall of a cohort update, the spans around each
update(cohort=c) of the window (its tokens read back to the host).  A
window holds some tens of updates, too few for the tail that an
end-to-end metric would need."""

from portbench.readers import percentile_ms


def read(record):
    return percentile_ms(record, "update", 50)
