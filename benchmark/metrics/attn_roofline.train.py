"""The train step's attention, as a share of its roofline (%).

The bound of the profiled steps' attention launches (each forward and its
backward, at the configuration's shapes: ``benchmark/counts.py``) over the
device time of the kernels whose names hold the patterns below. None where
no such kernel ran."""

from benchmark import counts

PATTERNS = ("attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")


def read(trace):
    steps = trace.counts.get("steps")
    ops = [e for e in trace.kernels() if any(p in e.name for p in PATTERNS)]
    if not steps or not ops:
        return None
    bound = steps * counts.attention_bound_s(trace.config["model"], trace.traffic["batch"],
                                             backward=True)
    return 100.0 * bound * 1e6 / sum(e.dur for e in ops)
