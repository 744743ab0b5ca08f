"""Does a zero-init learnable adjacency A recover the true causal graph?

Port of ``scripts/validate_adjacency.py``: short training runs with
``learn_adjacency=True`` on the synthetic SCM data (whose generator's graph
is the preset's adjacency, so the truth is known by construction), through
the port's training loop; then the learned A, read from the model's
``state_dict`` (``causal_mask.A``), is scored against that graph: each
seed's matrix, and the thresholded off-diagonal edge precision and recall
pooled over the seeds (the SCM adds u_i back outside A, so self-loops are
unidentified by design). Prints the pooled scores as one JSON line and
writes every run's to ``--out``.

Usage:
  python -m causaldiffae_torch.validate_adjacency --preset morphomnist_causaldae \\
      --steps 4000 --seeds 0 1 2 --out adjacency_validation.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .config import create_diffusion, get_config
from .data import synthetic_iterator
from .ops import prepare
from .serve import build_model
from .training.loop import run_training

__all__ = ["score", "learned_A", "main"]


def learned_A(model: torch.nn.Module) -> np.ndarray:
    """The learnable adjacency of ``model``'s SCM; raises ``KeyError``
    without one (``learn_adjacency`` off)."""
    sd = model.state_dict()
    if "causal_mask.A" not in sd:
        raise KeyError("no learnable A in the state_dict (learn_adjacency off?)")
    return sd["causal_mask.A"].detach().float().cpu().numpy()


def score(A, truth, threshold):
    """Off-diagonal thresholded edge precision/recall (the JAX script's ``score``)."""
    n = A.shape[0]
    off = ~np.eye(n, dtype=bool)
    pred = (np.abs(A) > threshold) & off
    true = (np.asarray(truth) != 0) & off
    tp = int((pred & true).sum())
    fp = int((pred & ~true).sum())
    fn = int((~pred & true).sum())
    return {"tp": tp, "fp": fp, "fn": fn,
            "precision": tp / max(tp + fp, 1), "recall": tp / max(tp + fn, 1)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="morphomnist_causaldae")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--threshold", type=float, default=0.05,
                   help="|A_ij| above this counts as a predicted edge")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--out", default="adjacency_validation.json")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    base = get_config(args.preset)
    if base.adjacency is None:
        raise SystemExit(f"--preset {args.preset} has no causal graph to recover")
    truth = np.asarray(base.adjacency, dtype=np.float32)
    cfg0 = base.replace(
        learn_adjacency=True, total_steps=args.steps,
        # the KL anneals over the short budget, so that the alignment pressure
        # (the only signal that can move A) is felt
        kl_anneal_steps=args.steps, log_interval=max(args.steps // 10, 1),
        **({"batch_size": args.batch_size} if args.batch_size else {}))
    prepare(args.device, cfg0.use_kernels, cfg0.use_bf16, training=True)
    results = {"preset": args.preset, "steps": args.steps, "threshold": args.threshold,
               "truth": truth.tolist(), "runs": []}
    pooled = {"tp": 0, "fp": 0, "fn": 0}
    for seed in args.seeds:
        cfg = cfg0.replace(seed=seed)
        model = build_model(cfg, "", seed, args.device)
        data = synthetic_iterator(cfg.dataset, cfg.batch_size, seed=seed,
                                  image_size=cfg.image_size)
        state, _ = run_training(cfg, model, create_diffusion(cfg), data,
                                total_steps=args.steps, log_interval=cfg.log_interval,
                                device=args.device)
        A = learned_A(state.model)
        s = score(A, truth, args.threshold)
        for k in pooled:
            pooled[k] += s[k]
        print(f"seed {seed}: A=\n{np.round(A, 4)}\n  {s}", file=sys.stderr, flush=True)
        results["runs"].append({"seed": seed, "A": A.tolist(), **s})
    results["pooled"] = {
        **pooled,
        "precision": pooled["tp"] / max(pooled["tp"] + pooled["fp"], 1),
        "recall": pooled["tp"] / max(pooled["tp"] + pooled["fn"], 1),
    }
    print(json.dumps(results["pooled"]), flush=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(f"wrote {args.out}", file=sys.stderr, flush=True)
    return results


if __name__ == "__main__":
    main()
