"""Prior sampling: z ~ N(0, I), x_T ~ N(0, I), then the generation chain.

The port's counterpart of ``scripts/sample.py``, through
``evals.make_prior_sample_fn``: batches of ``--batch_size`` until
``--num_samples`` are drawn, conditioned on class labels ``arange(B) % 10``
and a zero context as the preset needs them. Writes
``samples_<N>x<H>x<W>.npz`` (``arr_0``, NHWC) and ``grid.png``; prints
``{"path", "shape", "finite"}``.

Usage:
  python -m causaldiffae_torch.sample --ckpt_dir ckpt/morpho --num_samples 64 \\
      --sampler dpm++ --sample_steps 25
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import DATA_SCALES, create_diffusion
from .evals import make_prior_sample_fn
from .evals.cli import restore_model, start
from .serve import str2bool
from .utils import logger
from .utils.images import save_grid

BATCH_STREAM = 0x5A3F0  # keeps the batch seeds apart from other uses of seed + i


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=None,
                   help="default morphomnist_causaldae; with --ckpt_dir, the checkpoint's")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--use_ddim", action="store_true")
    p.add_argument("--sampler", choices=["ddim", "ddpm", "dpm++"], default=None)
    p.add_argument("--sample_steps", type=int, default=None, help="dpm++ node budget")
    p.add_argument("--use_ema", type=str2bool, default=False)
    p.add_argument("--out_dir", default="causaldiffae_samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.sample_steps is not None and args.sampler != "dpm++":
        p.error("--sample_steps only applies to --sampler dpm++")
    if args.batch_size < 1 or args.num_samples < 1:
        p.error("--batch_size and --num_samples must be >= 1")
    return args


def main(argv: Optional[List[str]] = None) -> str:
    args = parse_args(argv)
    start(args.device)
    cfg, model, _ = restore_model(args.preset, args.ckpt_dir, args.use_ema, args.seed,
                                  args.device)
    fn = make_prior_sample_fn(cfg, model, create_diffusion(cfg, eval_mode=True),
                              use_ddim=args.use_ddim, sampler=args.sampler,
                              sample_steps=args.sample_steps)
    bs, device = args.batch_size, args.device
    shape = (bs, cfg.image_size, cfg.image_size, cfg.in_channels)
    cond = {}
    if cfg.class_cond:
        cond["y"] = torch.arange(bs, device=device) % 10
    if cfg.context_cond:
        cond["c"] = torch.zeros(bs, len(DATA_SCALES[cfg.dataset]), device=device)
    images = []
    for i in range(-(-args.num_samples // bs)):
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(
            args.seed * 1_000_003 + BATCH_STREAM + i)
        images.append(fn(shape, cond, gen, device=device).cpu().numpy())
        logger.log(f"created {len(images) * bs} samples; batch {time.perf_counter() - t0:.3f} s")
    arr = np.concatenate(images, 0)[:args.num_samples]
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"samples_{arr.shape[0]}x{arr.shape[1]}x{arr.shape[2]}.npz")
    np.savez(path, arr_0=arr)
    save_grid(arr[:64], os.path.join(args.out_dir, "grid.png"))
    print(json.dumps({"path": path, "shape": list(arr.shape),
                      "finite": bool(np.isfinite(arr).all())}), flush=True)
    return path


if __name__ == "__main__":
    main()
