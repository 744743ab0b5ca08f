"""The requests' attention forwards, as a share of their roofline (%): the
bound of every launch of the profiled UNet calls at the configuration's
shapes (``benchmark/counts.py``) over the device time of the kernels whose
names hold the pattern below. None where no such kernel ran."""

from benchmark import counts

PATTERNS = ("attention_fwd_kernel",)


def read(trace):
    calls = trace.counts.get("unet_calls")
    ops = [e for e in trace.kernels() if any(p in e.name for p in PATTERNS)]
    if not calls or not ops:
        return None
    bound = calls * counts.attention_bound_s(trace.config["model"], trace.traffic["batch"],
                                             backward=False)
    return 100.0 * bound * 1e6 / sum(e.dur for e in ops)
