"""Whole step: audio seconds of every clip whose transcript came back in
the window, over the window's wall (host clock; the host's launches bound
it, and the host's speed spreads it from run to run)."""

from portbench.readers import window_rate


def read(record):
    return window_rate(record)
