"""Host ms per train step in the program's feed: the spans
``cdae.train.data.next``, ``.copy`` and ``.ready`` of the loop's ``_Feed``
(one each a step), each the mean of its warm occurrences, summed. The inside
twin of ``data_wait_ms.train``, which times the same calls from outside."""

from benchmark import program

SPANS = ("cdae.train.data.next", "cdae.train.data.copy", "cdae.train.data.ready")


def read(trace):
    snap = program.snapshot()
    parts = [program.warm_ms(snap, name) for name in SPANS]
    return None if None in parts else sum(parts)
