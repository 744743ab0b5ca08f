"""Model FLOPs of a train step (three forwards, no recompute; counted from
the configuration's shapes by ``benchmark/counts.py``) over its wall time on
the host clock, the window's steps outside the profiled part, at the bf16
peak of 989 TFLOP/s (%). The source is the host clock: the trace only
shows that kernels ran, since the profiler's host cost would lengthen the
profiled steps."""

from benchmark import counts


def read(trace):
    wall = trace.counts.get("wall_ms_per_step")
    if not wall or not trace.kernels():
        return None
    flops = counts.train_step_flops(trace.config["model"], trace.traffic["batch"])
    return 100.0 * flops / (wall / 1e3 * counts.PEAK_BF16_FLOPS)
