"""The readings that the limits of ``correct`` are set from.

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... [--fault-seeds 3]

For each seed, at the cell's own size, without a window: the port's numbers
(the lower reading), the control's (the float32 reference computed one
precision below the configuration's bfloat16, in float8 e4m3 with a scale
per tensor, put in the port's place) and, on the first ``--fault-seeds``
seeds, each fault the generator can plant in the timed path. One JSON line per
reading, then a summary: the largest program reading and the smallest
control and fault readings of each number. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List

from benchmark import run as RUN
from benchmark.reference import model as M
from benchmark.reference import train as RT

FAULTS = {"train": ("half_batch", "state_unchanged"),
          "counterfactual": ("answer_altered", "step_unchanged")}


def _emit(rows: List[dict], seed: int, kind: str, numbers: Dict[str, float]) -> None:
    row = {"seed": seed, "kind": kind, **numbers}
    rows.append(row)
    print(json.dumps(row), flush=True)


def _worst(m, ref, other) -> List[list]:
    """The gradient's worst leaves, for a look at what sets ``grad_gap``."""
    return [[round(g, 5), k, p, q, med] for g, k, p, q, med in
            RT.worst_leaves(RT.leaves(m, other["grad"]), RT.leaves(m, ref["grad"]))]


def _train_numbers(m, ref, other, start) -> Dict[str, float]:
    """The cell's numbers, and each step's loss gap on its own (``loss_gap_<i>``)."""
    out = RT.compare(m, ref, other, start)
    for i, (p, q) in enumerate(zip(other["loss"], ref["loss"])):
        out[f"loss_gap_{i + 1}"] = abs(p - q) / abs(q)
    return out


def train_readings(r, seed: int, faults: bool, rows: List[dict], look: bool = False) -> None:
    D = r.generator
    s = D.Setup(r)
    prog = s.check_steps()
    kept = s.kept
    s.free()
    ref, start, _ = D.reference(r, kept)
    m = r.config["model"]
    _emit(rows, seed, "program", _train_numbers(m, ref, prog, start))
    if look:
        print(json.dumps({"seed": seed, "look": "program", "worst": _worst(m, ref, prog)}))
        r.config["model"]["use_kernels"] = False   # the port's plain attention, a witness
        s = D.Setup(r)
        plain = s.check_steps()
        s.free()
        r.config["model"]["use_kernels"] = True
        _emit(rows, seed, "plain_attention", _train_numbers(m, ref, plain, start))
        print(json.dumps({"seed": seed, "look": "plain_attention",
                          "worst": _worst(m, ref, plain)}))
        bf16, _, _ = D.reference(r, kept, M.bf16_cast)
        _emit(rows, seed, "reference_bf16", _train_numbers(m, ref, bf16, start))
        print(json.dumps({"seed": seed, "look": "reference_bf16", "worst": _worst(m, ref, bf16)}))
    ctrl, _, _ = D.reference(r, kept, M.fp8_cast)
    _emit(rows, seed, "control", _train_numbers(m, ref, ctrl, start))
    if look:
        print(json.dumps({"seed": seed, "look": "control", "worst": _worst(m, ref, ctrl)}))
    for fault in FAULTS["train"] if faults else ():
        s = D.Setup(r, fault)
        bad = s.check_steps()
        s.free()
        _emit(rows, seed, fault, _train_numbers(m, ref, bad, start))


def serve_readings(r, seed: int, faults: bool, rows: List[dict]) -> None:
    D = r.generator
    reqs = D.Requests(r)
    made = [reqs.make(k) for k in range(r.traffic["check_requests"])]

    def answers(fault):
        port = D.Port(r, fault)
        got = {}
        for k, req in enumerate(made):
            port.answer(D.on_device(req, r.device), record=True).cpu()
            got[k] = (req, port.record)
        port.free()
        return got

    _emit(rows, seed, "program", D.reference_numbers(r, answers(None), reqs))
    checked = {k: (req, None) for k, req in enumerate(made)}
    _emit(rows, seed, "control", D.reference_numbers(r, checked, reqs, cast=M.fp8_cast))
    for fault in FAULTS["counterfactual"] if faults else ():
        _emit(rows, seed, fault, D.reference_numbers(r, answers(fault), reqs))


def main(argv=None, root=RUN.ROOT) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--look", action="store_true",
                   help="training: also the gradient's worst leaves, the port with its plain "
                        "attention, and the reference rounded to bf16")
    args = p.parse_args(argv)
    RUN.set_cache_dirs(RUN.ROOT)
    rows: List[dict] = []
    for i, seed in enumerate(args.seeds):
        r = RUN.Run(args.workload, seed, 0.0, False, args.device, root)
        if r.traffic["generator"] == "train":
            train_readings(r, seed, i < args.fault_seeds, rows, args.look)
        else:
            serve_readings(r, seed, i < args.fault_seeds, rows)
    summary = {}
    for kind in sorted({row["kind"] for row in rows}):
        keys = [k for k in rows[0] if k not in ("seed", "kind")]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(row[k] for row in rows if row["kind"] == kind
                                 if not math.isnan(row[k])) for k in keys}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
