"""``torch.cuda.max_memory_allocated`` over the window, reset at its start (GiB)."""


def read(trace):
    peak = trace.counts.get("peak_mem_bytes")
    return peak / 2 ** 30 if peak else None
