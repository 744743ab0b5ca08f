"""Host ms per train step in the data iterator's ``next`` (the loader): the
program's span ``cdae.train.data.next``, mean of its warm occurrences."""

from benchmark import program


def read(trace):
    return program.warm_ms(program.snapshot(), "cdae.train.data.next")
