"""Re-score saved counterfactual samples with a fixed set of probes.

The port's counterpart of ``scripts/rescore_counterfactuals.py``. Probes
retrained per evaluation can move MAE on generated images by ~0.1, the order
of the effects compared; this CLI scores the ``samples_do_<var>.npz`` of one
or more evaluation runs with the SAME probes (``classifier_<dataset>_<var>.pkl``
of either package, and every ``_seed<k>`` ensemble member), against the
ground truth replayed from the evaluation's ``RandomState(seed)`` stream
(``interventions.intervention_plan``). Prints one JSON line per run:
``{"run", "mae_<var>", and with an ensemble "mae_<var>_probes",
"mae_<var>_spread"}``.

Usage:
  python -m causaldiffae_torch.rescore_counterfactuals --preset morphomnist_causaldae \\
      --classifier_dir eval/a --num_samples 64 --batch_size 16 --runs eval/a eval/b
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from .config import get_config
from .data import synthetic_dataset
from .evals import classifier_predict_fn, load_classifier
from .evals.cli import start
from .interventions import VAR_NAMES, intervention_plan


def check_replay_stamps(archive, path: str, *, seed: int, batch_size: int,
                        num_samples: int, n_rows_expected: int) -> None:
    """Refuse to mis-score: the replayed stream is valid only for a run made
    with the same plan. ``seed`` and ``batch_size`` drive every draw;
    ``num_samples`` sizes the pool (max(num_samples, 512) rows seeded seed+99)
    and the batch count, so a mismatch shifts every draw after the first; a
    multi-process run (process_count > 1) interleaves streams; a real-data
    run (synthetic_pool 0) has other ground truth. Archives without a stamp
    pass that check."""
    for key, want in (("seed", seed), ("batch_size", batch_size), ("process_count", 1),
                      ("num_samples", num_samples), ("synthetic_pool", 1)):
        if key in archive and int(archive[key]) != want:
            raise SystemExit(
                f"{path}: run was generated with {key}={int(archive[key])} but the replay "
                f"assumes {want}; pass matching flags (multi-process or real-data runs can't "
                f"be replayed from the synthetic single-process stream)")
    n = len(archive["samples"])
    if n != n_rows_expected:
        raise SystemExit(f"{path}: {n} samples but the replay plan has {n_rows_expected} rows; "
                         f"pass the run's --num_samples/--batch_size")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--classifier_dir", required=True,
                   help="holds classifier_<dataset>_<var>.pkl (and _seed<k> members)")
    p.add_argument("--runs", nargs="+", required=True,
                   help="evaluation out_dirs holding samples_do_<var>.npz")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    start(args.device)
    cfg = get_config(args.preset)
    dataset, names = cfg.dataset, VAR_NAMES[cfg.dataset]
    # only the labels are replayed; they are drawn before the render, so a
    # small render gives the evaluation pool's labels
    c_pool = synthetic_dataset(dataset, max(args.num_samples, 512), seed=args.seed + 99,
                               image_size=8)["c"]
    n_batches = max(args.num_samples // args.batch_size, 1)
    _, plan = intervention_plan(dataset, c_pool, seed=args.seed, batch_size=args.batch_size,
                                n_batches=n_batches)
    members = []  # per factor: [(label, predict)]
    for name in names:
        paths = sorted(glob.glob(os.path.join(args.classifier_dir,
                                              f"classifier_{dataset}_{name}_seed*.pkl")))
        single = os.path.join(args.classifier_dir, f"classifier_{dataset}_{name}.pkl")
        if os.path.exists(single):
            paths.insert(0, single)
        if not paths:
            raise SystemExit(f"no classifier pickles for factor {name!r} in "
                             f"{args.classifier_dir}")
        probes = []
        for path in paths:
            model, _ = load_classifier(path, cfg.n_vars, cfg.image_size, cfg.in_channels,
                                       device=args.device)
            stem = os.path.basename(path)[:-len(".pkl")]
            probes.append((stem.split("_seed")[-1] if "_seed" in stem else "0",
                           classifier_predict_fn(model)))
        members.append(probes)

    results = []
    for run_dir in args.runs:
        mae = {name: {} for name in names}  # factor -> probe label -> per-batch MAEs
        for name, batches in zip(names, plan):
            path = os.path.join(run_dir, f"samples_do_{name}.npz")
            with np.load(path) as archive:
                check_replay_stamps(archive, path, seed=args.seed, batch_size=args.batch_size,
                                    num_samples=args.num_samples,
                                    n_rows_expected=n_batches * args.batch_size)
                samples = archive["samples"]
            for b, req in enumerate(batches):
                chunk = samples[b * args.batch_size:(b + 1) * args.batch_size]
                x = torch.from_numpy(np.clip(chunk, 0, 1)).to(args.device)
                for f, probes in enumerate(members):
                    for label, predict in probes:
                        out = predict(x).cpu().numpy()
                        mae[names[f]].setdefault(label, []).append(
                            np.abs(out - req.gt_norm[:, f]).mean())
        result = {"run": run_dir}
        for k, by_probe in mae.items():
            per = {label: float(np.mean(v)) for label, v in by_probe.items()}
            vals = list(per.values())
            result[f"mae_{k}"] = float(np.mean(vals))
            if len(per) > 1:
                result[f"mae_{k}_probes"] = per
                result[f"mae_{k}_spread"] = float(np.max(vals) - np.min(vals))
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main()
