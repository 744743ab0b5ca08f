"""Host ms per request before its chain: the program's span
``cdae.cf.prepare`` (encode, do(), SCM, q_sample), mean of its warm
occurrences."""

from benchmark import program


def read(trace):
    return program.warm_ms(program.snapshot(), "cdae.cf.prepare")
