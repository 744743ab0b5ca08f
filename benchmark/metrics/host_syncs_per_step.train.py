"""Runtime calls that block the host, per profiled train step.

Counted as ``causaldiffae_torch/profile_training.py`` counts them: host
events whose name holds ``Synchronize``; the benchmark's own closing
synchronisation (inside its ``bench.close`` span) is left out."""


def read(trace):
    steps = trace.counts.get("steps")
    if not steps or trace.window is None:
        return None
    closes = trace.spans("bench.close")
    syncs = [e for e in trace.in_window(trace.host) if "Synchronize" in e.name
             and not any(c.start <= e.start and e.end <= c.end for c in closes)]
    return len(syncs) / steps
