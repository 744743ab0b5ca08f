"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name, so a later change adds a cell, a
configuration, a traffic mix or a per-layer metric by adding files:

- ``BENCHMARK.json``: the cell names its configuration and its traffic; the
  configuration entry names its file (``benchmark/configs/<config>.json``:
  the port's preset, the widths as run, the source, the deployment).
- ``benchmark/traffic/<traffic>.json``: the mix's parameters; its ``generator``
  names the general generator that reads them (``benchmark/generators/<generator>.py``).
- ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares.
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric, with
  ``read(trace) -> float | None`` over ``benchmark.trace.Trace``.

A generator's ``run(r)`` gets the :class:`Run` below: it builds the port and
its inputs from the seed, warms up, calls ``r.open_window()``, drives the
port for ``r.seconds`` (profiling a fixed part with ``r.profiled`` when
``r.trace``), calls ``r.close_window()``, frees the port's state and checks
its outputs against ``benchmark/reference``. It returns ``attempted``,
``failed``, its end-to-end values (``e2e``), the numbers it compared, and
``host``: what it timed on the host clock outside the profiled part, which
the per-layer readers find in ``Trace.counts``, and optionally ``notes``:
lines about the window (how its work spread over time) printed on stderr.

The last line on stdout is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit); the last lines on
stderr repeat the checks. Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "causaldiffae_tpu")


def _process_start() -> float:
    """This process's start on the ``time.time`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs(root: Path) -> None:
    """Point every build and kernel cache into the checkout, at fixed paths,
    so that only the first run in a checkout builds. The port builds its
    CUDA kernels and the loader into ``build/causaldiffae_torch`` itself."""
    build = root / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / sub)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of one cell: its files, the seed and window, and the helpers
    a generator calls."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device: str,
                 root: Path = ROOT, started: Optional[float] = None):
        self.root = Path(root)
        self.bench = _read(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r}; have {sorted(cells)}")
        self.cell = cells[workload]
        entry = {c["name"]: c for c in self.bench["configs"]}[self.cell["config"]]
        self.config = _read(self.root / entry["file"])
        bdir = self.root / "benchmark"
        self.traffic = _read(bdir / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = _read(bdir / "limits" / f"{workload}.json")
        self.generator = load_module(bdir / "generators" / f"{self.traffic['generator']}.py",
                                  f"_bench_generator_{self.traffic['generator']}")
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.started = started if started is not None else time.time()
        self.setup_s: Optional[float] = None
        self.peak_bytes = 0
        self.profile = None   # benchmark.trace.Trace of the profiled part
        self.fault = None     # a fault planted in the timed path (the tests' and calibrate's)
        self.profiling = False
        self.profiled_s = 0.0  # wall seconds of the profiled part
        self.host_s: Dict[str, float] = {}   # host seconds in each span, outside it
        self.host_n: Dict[str, int] = {}
        self.phases: List[tuple] = []   # (name, seconds from the process's start)

    # -- what a cell reports --------------------------------------------- #
    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.cell["name"] in m.get("workloads", [self.cell["name"]])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics of this cell: those that list it, and those
        without a list whose end-to-end metric this cell reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.cell["name"] in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in mine)]

    # -- helpers for the generator --------------------------------------- #
    def port_config(self):
        """The port's ``Config``: the preset, with the file's values as run."""
        from causaldiffae_torch.config import get_config

        return get_config(self.config["preset"]).replace(**self.config["model"])

    def phase(self, name: str) -> None:
        """Mark the end of a part of set-up, in seconds from the process's
        start; the run prints them on stderr, so a slow set-up shows where."""
        self.phases.append((name, time.time() - self.started))

    def synchronize(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def open_window(self) -> None:
        """Set-up ends: every shape is warm."""
        import torch

        self.synchronize()
        self.setup_s = time.time() - self.started
        self.phases.append(("window", self.setup_s))
        if self.device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()

    def close_window(self) -> None:
        """The window ends in a synchronisation; read the memory peak."""
        import torch

        self.synchronize()
        if self.device.startswith("cuda"):
            self.peak_bytes = torch.cuda.max_memory_allocated()

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own around a call into a layer: recorded
        by the profiler, and timed on the host clock outside the profiled
        part (``host_s``, ``host_n``), where the profiler's own cost is not
        in it."""
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(name):
            yield
        if not self.profiling:
            self.host_s[name] = self.host_s.get(name, 0.0) + time.perf_counter() - t
            self.host_n[name] = self.host_n.get(name, 0) + 1

    @contextlib.contextmanager
    def profiled(self, counts: Dict[str, float]):
        """Profile the block when tracing; ``counts`` is what the generator
        counts inside it (steps, requests, UNet calls)."""
        if not self.trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        from . import trace as T

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.synchronize()
        t = time.perf_counter()
        self.profiling = True
        with profile(activities=acts) as prof:
            with self.span("bench.profiled"):
                yield
                with self.span("bench.close"):
                    self.synchronize()
        self.profiling = False
        self.profile = T.from_profiler(prof, counts, self.config, self.traffic)
        self.profiled_s = time.perf_counter() - t


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, started: Optional[float] = None,
             fault: Optional[str] = None) -> dict:
    """Run the cell and return its result object (not printed). ``fault``
    plants one of the generator's faults in the timed path."""
    r = Run(workload, seed, seconds, trace, device, root, started)
    r.phase("harness")
    r.fault = fault
    out = r.generator.run(r)
    if r.setup_s is None:
        raise RuntimeError("the generator never opened its window")
    numbers, limits = out["numbers"], r.limits
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    correct = bool(limits) and all(_finite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(out["e2e"], setup_s=r.setup_s)
        for m in r.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": _device_name(device), "count": r.cell["chips"] if device.startswith("cuda")
           else 1, "memory_peak_bytes": r.peak_bytes}
    if trace:
        from . import trace as T

        prof = r.profile
        if prof is not None:
            prof.counts.setdefault("peak_mem_bytes", r.peak_bytes)
            prof.counts.update(out.get("host", {}))
            for m in r.per_layer():
                reader = load_module(r.root / "benchmark" / "metrics" / f"{m['name']}.py",
                                     f"_bench_metric_{m['name'].replace('.', '_')}")
                value = reader.read(prof)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            w = prof.window
            dev["busy_s"] = prof.busy_us() / 1e6
            dev["window_s"] = w.dur / 1e6 if w is not None else 0.0
            result["breakdown"] = T.breakdown(prof)
    result["device"] = dev
    result["phases"] = r.phases
    result["notes"] = out.get("notes", {})
    result["checks"] = checks
    return result


def _device_name(device: str) -> str:
    import torch

    if device.startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return "cpu"


def main(argv: Optional[List[str]] = None) -> int:
    started = _process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be >= 0")
    set_cache_dirs(ROOT)
    import torch

    chips = {w["name"]: w["chips"] for w in _read(ROOT / "BENCHMARK.json")["workloads"]}
    need = chips.get(args.workload)
    if need is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      started=started)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    phases = result.pop("phases")
    for name, text in result.pop("notes").items():
        print(f"{name} {text}", file=sys.stderr)
    print("setup_phases " + " ".join(f"{n} {t:.2f}" for n, t in phases), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
