"""Share of the profiled window in which no device operation ran (%): one
less the union of the device operations' intervals over the span of the
``bench.profiled`` window, which holds the profiled requests and ends in a
synchronisation. The profiler's own host cost is inside the window, so a
request whose host keeps up only just reads idler here than unprofiled."""


def read(trace):
    w = trace.window
    if w is None or not trace.kernels() or w.dur <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / w.dur)
