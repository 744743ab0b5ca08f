"""Host ms from a UNet call's entry to its return: the benchmark's
``bench.unet_call`` span around ``CausalUNet.denoise``, timed on the host
clock, mean over the window's calls outside the profiled part."""


def read(trace):
    return trace.counts.get("host_ms_per_unet_call")
