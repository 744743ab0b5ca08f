"""Device time of a train step: the profiled steps' device operations, summed, per step (ms)."""


def read(trace):
    steps, ops = trace.counts.get("steps"), trace.kernels()
    if not steps or not ops:
        return None
    return sum(e.dur for e in ops) / 1e3 / steps
