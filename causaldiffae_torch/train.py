"""Train a preset with the port.

The port's counterpart of ``scripts/train.py``, for the options this slice
carries: build the model from ``--preset``, take its weights from
``--init_from`` (an ``.npz`` of flax variables or a reference-key ``.pt``)
or a seeded init, feed it the synthetic pool made from ``--seed`` at the
preset's batch size, and run ``--total_steps`` train steps, printing one
JSON line every ``--log_interval`` steps with the step, the metrics, the
host-clock time per step and samples per second. On the card the attention
kernels are built at start-up. Checkpoints, resume and real data are not
ported yet.

Usage:
  python -m causaldiffae_torch.train --preset morphomnist_causaldae --total_steps 100
  python -m causaldiffae_torch.train ... --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch

from .config import create_diffusion, get_config
from .data import synthetic_iterator
from .ops import _build
from .serve import build_model
from .training import run_training
from .training.state import TrainState


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="morphomnist_causaldae")
    p.add_argument("--total_steps", type=int, default=None,
                   help="train steps to run (default: the preset's)")
    p.add_argument("--log_interval", type=int, default=None,
                   help="steps between JSON lines (default: the preset's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_from", default="",
                   help=".npz of flax variables or reference-key .pt (default: seeded init)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for name in ("total_steps", "log_interval"):
        value = getattr(args, name)
        if value is not None and value < 1:
            p.error(f"--{name} {value}: must be >= 1")
    return args


def main(argv: Optional[List[str]] = None) -> Tuple[TrainState, List[dict]]:
    args = parse_args(argv)
    cfg = get_config(args.preset).replace(seed=args.seed)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu to train on the CPU")
        if cfg.use_kernels and cfg.use_bf16:  # at start-up, not inside the first step
            _build.build("attention_fwd")
            _build.build("attention_bwd")
    model = build_model(cfg, args.init_from, args.seed, args.device)
    data = synthetic_iterator(cfg.dataset, cfg.batch_size, seed=args.seed,
                              image_size=cfg.image_size)
    return run_training(cfg, model, create_diffusion(cfg), data,
                        total_steps=args.total_steps or cfg.total_steps,
                        log_interval=args.log_interval or cfg.log_interval, device=args.device)


if __name__ == "__main__":
    main()
