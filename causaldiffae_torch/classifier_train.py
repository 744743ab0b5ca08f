"""Train anti-causal probes (the instruments of effectiveness MAE).

The port's counterpart of ``scripts/classifier_train.py``: regress one
causal factor (``--factor -1``: every factor) from images with
``GaussianConvEncoderClf`` (MSE, Adam, best-validation weights), on the
synthetic pool made from ``--seed`` or a real dataset's train/test splits,
and pickle it as ``classifier_<dataset>_<var>.pkl`` (``--seeds``: an
ensemble, ``classifier_<dataset>_<var>_seed<k>.pkl``, which
``rescore_counterfactuals`` scores with member by member).

Usage:
  python -m causaldiffae_torch.classifier_train --dataset morphomnist --factor -1 \\
      --synthetic --seeds 0 1 2 --out_dir probes [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .data import load_split, synthetic_dataset
from .evals import ClassifierTrainer
from .evals.cli import start
from .interventions import VAR_NAMES
from .utils import logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True, choices=list(VAR_NAMES))
    p.add_argument("--factor", type=int, required=True, help="factor index; -1 trains every factor")
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="train an ensemble: one probe per seed, saved with a _seed<k> suffix")
    p.add_argument("--data_dir", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pool", type=int, default=4096)
    p.add_argument("--out_dir", default="causaldiffae_classifiers")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not -1 <= args.factor < len(VAR_NAMES[args.dataset]):
        p.error(f"--factor {args.factor}: {args.dataset} has {len(VAR_NAMES[args.dataset])}")
    return args


def main(argv: Optional[List[str]] = None) -> List[str]:
    args = parse_args(argv)
    start(args.device)
    names = VAR_NAMES[args.dataset]
    if args.synthetic or not args.data_dir:
        train = synthetic_dataset(args.dataset, args.pool, seed=args.seed)
        val = synthetic_dataset(args.dataset, max(args.pool // 10, 64), seed=args.seed + 7)
    else:
        train = load_split(args.dataset, args.data_dir, "train")
        val = load_split(args.dataset, args.data_dir, "test")
    factors = range(len(names)) if args.factor < 0 else [args.factor]
    paths = []
    for factor in factors:
        for seed in args.seeds or [args.seed]:
            trainer = ClassifierTrainer(args.dataset, factor, len(names), lr=args.lr, seed=seed,
                                        device=args.device)
            trainer.fit(train, val, epochs=args.epochs, batch_size=args.batch_size)
            suffix = f"_seed{seed}" if args.seeds else ""
            path = os.path.join(args.out_dir,
                                f"classifier_{args.dataset}_{names[factor]}{suffix}.pkl")
            trainer.save_best(path)
            logger.log(f"saved best (val {trainer.best_val:.5f}) -> {path}")
            paths.append(path)
    return paths


if __name__ == "__main__":
    main()
