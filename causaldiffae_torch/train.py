"""Train a preset with the port.

The port's counterpart of ``scripts/train.py``: build the model from
``--preset`` (with the preset override flags), take its weights from
``--init_from`` (an ``.npz`` of flax variables or a reference-key ``.pt``)
or a seeded init, feed it the synthetic pool made from ``--seed`` or the
real dataset under ``--data_dir``, and train up to ``--total_steps``. Every
``--log_interval`` steps one JSON line goes to stdout and a row to
``progress.csv`` (with ``progress.json`` and ``log.txt``) under
``--logdir``. Checkpoints go to ``--ckpt_dir`` (default
``<logdir>/checkpoints/<preset>``; none without either flag) every
``--save_interval`` steps, at the end, and on SIGTERM/SIGINT, each with the
config it trained (overrides included); a rerun of the same command resumes
from the latest one unless ``--no_resume``, and a checkpoint wins over
``--init_from``. ``OPENAI_LOG_FORMAT`` picks the logdir's formats (default
``log,csv,json``; ``tensorboard`` adds an event file). On the card the
attention kernels are built at start-up, and cuDNN is held to deterministic
algorithms (``utils.determinism``), so that a rerun gives the same bits.

Data parallelism: started by ``torchrun --nproc_per_node N``, every rank
joins the process group (NCCL with one card per local rank,
``cuda:LOCAL_RANK``; gloo with ``--device cpu``), builds the kernels, feeds
its shard of the data and trains the DDP-wrapped model (``parallel/``).
``--batch_size`` stays the GLOBAL batch, split evenly over the ranks, and W
ranks take the step one process at that batch takes; the primary rank
alone logs and writes checkpoints.

Tensor parallelism: ``--model_parallel k`` groups the W ranks into W/k data
rows of k model ranks (the model rank innermost) and cuts every ResBlock's
conv pair over the k ranks of a row, Megatron's way (``parallel/grid.py``,
``parallel/partition.py``); the rest of the model is replicated, and DDP
runs over the W/k ranks of each model column. k must divide W; one process
takes only k = 1. The checkpoints hold the whole model, so they resume at
any k and the serve and evaluation CLIs load them. ``--use_remat true``
recomputes each ResBlock in the backward pass (less memory, more time).

Usage:
  python -m causaldiffae_torch.train --preset circuit_causaldae --synthetic \\
      --logdir runs/circuit --total_steps 20000
  python -m causaldiffae_torch.train --preset pendulum_causaldae --data_dir data/pendulum \\
      --ckpt_dir ckpt/pendulum
  python -m causaldiffae_torch.train ... --device cpu
  torchrun --nproc_per_node 8 -m causaldiffae_torch.train --preset morphomnist_causaldae \
      --synthetic --batch_size 128 --ckpt_dir ckpt/morpho
  torchrun --nproc_per_node 4 -m causaldiffae_torch.train --preset circuit_causaldae \
      --synthetic --model_parallel 2 --use_remat true --ckpt_dir ckpt/circuit
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import torch

from .config import create_diffusion, get_config
from .data import load_data, synthetic_iterator
from .ops import prepare
from .parallel import init_from_env, init_grid
from .serve import build_model, str2bool
from .training import run_training
from .training.state import TrainState
from .utils import determinism, logger

OVERRIDES = [("batch_size", int), ("microbatch", int), ("lr", float), ("total_steps", int),
             ("lr_anneal_steps", int), ("log_interval", int), ("save_interval", int),
             ("diffusion_steps", int), ("seed", int), ("ema_rate", str),
             ("schedule_sampler", str), ("weight_decay", float), ("kl_anneal_steps", int),
             ("model_parallel", int)]
BOOL_OVERRIDES = ("use_bf16", "flow_based", "learn_sigma", "learn_adjacency", "use_kl",
                  "predict_xstart", "use_remat", "masking", "causal_modeling", "use_kernels")
POSITIVE = ("batch_size", "total_steps", "log_interval", "save_interval", "model_parallel")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="morphomnist_causaldae")
    p.add_argument("--data_dir", default="", help="real dataset (default: the synthetic pool)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the built-in synthetic SCM data even with --data_dir")
    p.add_argument("--logdir", default=None, help="progress.csv, progress.json and log.txt")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoints (default: <logdir>/checkpoints/<preset>)")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--init_from", default="",
                   help=".npz of flax variables or reference-key .pt (default: seeded init); "
                        "a checkpoint in --ckpt_dir wins unless --no_resume")
    p.add_argument("--device", default="cuda")
    for flag, typ in OVERRIDES:
        p.add_argument(f"--{flag}", type=typ, default=None)
    for flag in BOOL_OVERRIDES:
        p.add_argument(f"--{flag}", type=str2bool, default=None)
    args = p.parse_args(argv)
    for name in POSITIVE:
        value = getattr(args, name)
        if value is not None and value < 1:
            p.error(f"--{name} {value}: must be >= 1")
    return args


def main(argv: Optional[List[str]] = None) -> Tuple[TrainState, List[dict]]:
    args = parse_args(argv)
    determinism.pin()  # two runs from the same seed end bit-equal on the card too
    cfg = get_config(args.preset)
    overrides = {k: v for k, v in vars(args).items() if v is not None and hasattr(cfg, k)}
    cfg = cfg.replace(**overrides)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to train on the CPU")
    device = init_from_env(args.device)  # under torchrun: this rank's card
    try:
        init_grid(cfg.model_parallel)  # before the data: a data row feeds its TP ranks alike
    except ValueError as e:
        raise SystemExit(f"--model_parallel {cfg.model_parallel}: {e}") from None
    prepare(device, cfg.use_kernels, cfg.use_bf16, training=True)  # not inside the first step
    formats = os.environ.get("OPENAI_LOG_FORMAT", "log,csv,json").split(",")
    logger.configure(dir=args.logdir, format_strs=formats if args.logdir else [])
    logger.log(f"config: {cfg}")
    ckpt_dir = args.ckpt_dir or (os.path.join(args.logdir, "checkpoints", cfg.name)
                                 if args.logdir else None)
    model = build_model(cfg, args.init_from, cfg.seed, device)
    if args.data_dir and not args.synthetic:
        data = load_data(data_dir=args.data_dir, batch_size=cfg.batch_size,
                         image_size=cfg.image_size, class_cond=cfg.class_cond, seed=cfg.seed)
    else:
        data = synthetic_iterator(cfg.dataset, cfg.batch_size, seed=cfg.seed,
                                  image_size=cfg.image_size)
    try:
        return run_training(cfg, model, create_diffusion(cfg), data,
                            total_steps=cfg.total_steps, log_interval=cfg.log_interval,
                            device=device, ckpt_dir=ckpt_dir, resume=not args.no_resume)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
