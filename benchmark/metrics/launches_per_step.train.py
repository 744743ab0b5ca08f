"""Device operations (kernels, copies, sets) per profiled train step."""


def read(trace):
    steps, ops = trace.counts.get("steps"), trace.kernels()
    if not steps or not ops:
        return None
    return len(ops) / steps
