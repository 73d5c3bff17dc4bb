"""Device: operations launched on the device per decoder step, in the
traced decodes (a count: kernels, copies and sets)."""


def read(record):
    sessions = [s for s in record.sessions if "steps" in s.info]
    steps = sum(s.info["steps"] for s in sessions)
    if not steps:
        return None
    return sum(len(s.device_ops) for s in sessions) / steps
