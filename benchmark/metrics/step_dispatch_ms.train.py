"""Host ms per train step spent dispatching it: the program's span
``cdae.train.step`` less ``cdae.train.step.wait`` inside it (the step's
blocking ``kl_weight`` copy, where the host waits for the device), each the
mean of its warm occurrences."""

from benchmark import program


def read(trace):
    snap = program.snapshot()
    step, wait = (program.warm_ms(snap, n) for n in ("cdae.train.step", "cdae.train.step.wait"))
    return None if step is None or wait is None else step - wait
