"""Device-idle ms per profiled train step in the gaps that begin while the
host is inside the program's ``cdae.train.step`` and not inside its
``cdae.train.step.wait``: the device waiting on the step's dispatch."""

from benchmark import program


def read(trace):
    steps, inside = trace.counts.get("steps"), trace.spans("cdae.train.step")
    if not steps or not inside or not trace.kernels():
        return None
    waits = trace.spans("cdae.train.step.wait")
    return program.idle_ms(trace, lambda t: program.covered(inside, t)
                           and not program.covered(waits, t)) / steps
