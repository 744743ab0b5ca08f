"""What the per-layer readers take from the port's own tracing
(``causaldiffae_torch/utils/tracing.py``).

Host-clock readers read its snapshot after the run: each span's count,
seconds, self seconds and first occurrence's seconds, summed outside the
profiled part (the tracing adds nothing while a profiler runs), and they use
the warm occurrences only, every one after the first. Those include the
set-up's after its first (the check and warm steps, the warm-up requests),
which the harness's own spans, timing the window alone, leave out. Trace
readers find the program's spans as host events in the profiled window. A
program without that module, or whose trace holds none of its spans, gives
nothing: the readers then return None.
"""

from __future__ import annotations

from typing import Callable, List, Optional


def snapshot() -> Optional[dict]:
    """The port's span and counter snapshot, or None where it has none."""
    try:
        from causaldiffae_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def warm_ms(snap: Optional[dict], name: str) -> Optional[float]:
    """Mean host ms of the span's occurrences after its first, set-up's
    among them, or None where it ran fewer than twice."""
    s = (snap or {}).get("spans", {}).get(name)
    if not s or s["n"] < 2:
        return None
    return 1e3 * (s["s"] - s["first_s"]) / (s["n"] - 1)


def covered(events: List, t: float) -> bool:
    """Whether one of ``events`` (host events) runs at time ``t``."""
    return any(e.start <= t < e.end for e in events)


def idle_ms(trace, begins: Callable[[float], bool]) -> float:
    """Device-idle ms in the window's gaps that begin where ``begins`` holds."""
    return sum(b - a for a, b in trace.gaps() if begins(a)) / 1e3
