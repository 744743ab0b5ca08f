"""Host ms per train step inside the feed's ``fetch`` and ``ready`` calls:
the benchmark's ``bench.data.fetch`` and ``bench.data.ready`` spans, timed
on the host clock over the window's steps outside the profiled part."""


def read(trace):
    return trace.counts.get("data_wait_ms")
