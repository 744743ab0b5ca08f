"""Device operations of the profiled requests per UNet call in them."""


def read(trace):
    calls, ops = trace.counts.get("unet_calls"), trace.kernels()
    if not calls or not ops:
        return None
    return len(ops) / calls
