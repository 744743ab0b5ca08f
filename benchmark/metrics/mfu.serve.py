"""Model FLOPs of a request (the encoder and SCM once, the UNet at every
call, per image; counted from the configuration's shapes by
``benchmark/counts.py``) over its mean latency on the host clock, the
window's requests outside the profiled part, at the bf16 peak of 989
TFLOP/s (%). The source is the host clock, as the profiler's host cost
would lengthen the profiled request; the benchmark counts the UNet calls a
request makes."""

from benchmark import counts


def read(trace):
    n, calls = trace.counts.get("requests"), trace.counts.get("unet_calls")
    wall = trace.counts.get("wall_ms_per_request")
    if not n or not calls or not wall or not trace.kernels():
        return None
    per_request = counts.request_flops(trace.config["model"], trace.traffic["batch"],
                                       round(calls / n))
    return 100.0 * per_request / (wall / 1e3 * counts.PEAK_BF16_FLOPS)
