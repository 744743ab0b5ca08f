"""Host ms per train step in ``cdae.train.step.wait``: ``kl_weight``'s
blocking copy alone, where the host waits for the step's device work; mean
of its warm occurrences."""

from benchmark import program


def read(trace):
    return program.warm_ms(program.snapshot(), "cdae.train.step.wait")
