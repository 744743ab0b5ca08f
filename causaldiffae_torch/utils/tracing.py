"""Spans and counters of the port's host side.

``span(name)`` is a context manager. Outside a profiler it adds the block's
host time (``time.perf_counter_ns``) to an aggregate per name: the count,
the total, the self time (the total less what its child spans cover, from a
stack of open spans: the port enters spans on the thread that drives it,
never in autograd's backward threads) and the first occurrence's time, kept
apart because lazy CUDA, cuDNN and operator initialisation lands there.
While a ``torch.profiler`` runs it adds nothing (the profiler's own host
cost would be in it; a span that ends under a profiler adds nothing either)
and enters ``torch.profiler.record_function(name)`` instead, so that the
range sits in the trace on the clock of the device operations it
dispatched. Under ``torch.compile`` or ``torch.export`` it does nothing, so
no traced graph holds a profiler op or a side effect.

``count(name, n)`` adds to an integer counter (also while a profiler runs).
``snapshot()`` returns both; its counters include those that a module keeps
itself and hands over with ``counters_from`` (the attention kernels' launch
counts, kept in ``ops/attention.py``). ``reset()`` clears what this module
keeps, not those. ``span_table`` and ``device_ops`` are the profiling
tools' views of a snapshot and of a profiler's events.

Every name starts with ``cdae.``; none holds ``Synchronize`` (a word the
benchmark's sync counter looks for in host event names).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "traced", "count", "counters_from", "snapshot", "reset", "span_table",
           "device_ops"]

_clock = time.perf_counter_ns
_compiling = torch.compiler.is_compiling
_exporting = torch.compiler.is_exporting
_spans: Dict[str, List[int]] = {}   # name -> [n, total ns, self ns, first ns]
_counters: Dict[str, int] = {}
_open: List["_Span"] = []   # the open spans, innermost last
_NULL = contextlib.nullcontext()
_new = object.__new__
_sources: List[Callable[[], Dict[str, int]]] = []   # counters kept by other modules


class _Span:
    __slots__ = ("name", "start", "child", "range")

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            return self
        self.range = None
        self.child = 0
        _open.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
            return False
        dt = _clock() - self.start
        _open.pop()
        if _open:
            _open[-1].child += dt
        if _profiler._is_profiler_enabled:   # a profiler started inside the span
            return False
        agg = _spans.get(self.name)
        if agg is None:
            _spans[self.name] = [1, dt, dt - self.child, dt]
        else:
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child
        return False


def span(name: str):
    """A context manager that times its block under ``name`` (see the module)."""
    if _compiling() or _exporting():
        return _NULL
    s = _new(_Span)
    s.name = name
    return s


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _compiling() or _exporting():
        return
    _counters[name] = _counters.get(name, 0) + n


def counters_from(read: Callable[[], Dict[str, int]]) -> None:
    """Put ``read()``'s counters, which their own module keeps and resets,
    into every snapshot."""
    _sources.append(read)


def snapshot() -> dict:
    """``{"spans": {name: {n, s, self_s, first_s}}, "counters": {name: int}}``:
    the spans' seconds outside any profiler and the counters since the
    process started or ``reset``, with those of ``counters_from``."""
    spans = {k: {"n": n, "s": t / 1e9, "self_s": s / 1e9, "first_s": f / 1e9}
             for k, (n, t, s, f) in _spans.items()}
    counters = dict(_counters)
    for read in _sources:
        counters.update(read())
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear the spans' aggregates and the counters of ``count``."""
    _spans.clear()
    _counters.clear()


def span_table(snap: dict, units: int) -> Dict[str, float]:
    """Self ms per unit (step, call) of each span in ``snap``, the largest
    first."""
    spans = sorted(snap["spans"].items(), key=lambda kv: -kv[1]["self_s"])
    return {name: v["self_s"] * 1e3 / units for name, v in spans}


def device_ops(prof) -> List[tuple]:
    """(name, device us, count) of each device operation in the finished
    profiler ``prof``: the device-side events only (a CPU op's own "device
    time" repeats its kernels'), not the device copies of the spans."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("cdae.")]
