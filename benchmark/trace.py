"""From a ``torch.profiler`` run to what the per-layer readers take.

The generator profiles a fixed number of steady steps or requests inside the
window, between a synchronisation before the profiler starts and one inside
the ``bench.profiled`` span at its end, so every device operation of those
steps falls inside the span. :class:`Trace` holds the device operations
(kernels, copies, sets) and the host events with their start and end in
microseconds on one clock, the benchmark's own spans (names starting
``bench.``), and the generator's counts of what the window held.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]


@dataclasses.dataclass
class Event:
    name: str
    start: float   # us
    end: float     # us

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    """The profiled part of one run.

    ``device``: every device operation; ``host``: every host event (runtime
    calls, operators, the benchmark's spans); ``counts``: what the generator
    counted in the profiled part (``steps``, ``requests``, ``unet_calls``)
    and set (``peak_mem_bytes``); ``config``/``traffic``: the cell's files.
    """
    device: List[Event]
    host: List[Event]
    counts: Dict[str, float]
    config: dict
    traffic: dict

    def spans(self, name: str) -> List[Event]:
        return [e for e in self.host if e.name == name]

    @property
    def window(self) -> Optional[Event]:
        """The ``bench.profiled`` span, or None."""
        s = self.spans("bench.profiled")
        return s[0] if s else None

    def in_window(self, events: List[Event]) -> List[Event]:
        w = self.window
        if w is None:
            return []
        return [e for e in events if e.start >= w.start and e.end <= w.end]

    def kernels(self) -> List[Event]:
        return self.in_window(self.device)

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals, merged and sorted."""
        merged: List[List[float]] = []
        for e in sorted(self.kernels(), key=lambda e: e.start):
            if merged and e.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end)
            else:
                merged.append([e.start, e.end])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> List[Interval]:
        """Where the device did nothing inside the window."""
        w = self.window
        if w is None:
            return []
        out, t = [], w.start
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if w.end > t:
            out.append((t, w.end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host event running at time ``t`` (the one that
        started last among those that cover it)."""
        best = None
        for e in self.host:
            if e.start <= t < e.end and (best is None or e.start > best.start):
                best = e
        return best.name if best is not None else "(none)"


def from_profiler(prof, counts: Dict[str, float], config: dict, traffic: dict) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        ev = Event(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(ev)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            device.append(ev)   # not the device-side copy of a span
    return Trace(device, host, dict(counts), config, traffic)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    longest idle gaps by what the host was doing as each began (seconds)."""
    by_name: Dict[str, float] = {}
    for e in trace.kernels():
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[trace.host_at(a), (b - a) / 1e6] for a, b in gaps]}

