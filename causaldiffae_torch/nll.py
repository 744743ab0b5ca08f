"""Negative log-likelihood in bits per dimension: the full VLB sweep.

The port's counterpart of ``scripts/nll.py``: for batches of the synthetic
pool (or a real dataset's test split), ``diffusion.calc_bpd_loop`` on the
training diffusion (not respaced: every one of its T steps, one UNet call
each), conditioned on z = z_post + sqrt(reparam_var_scale) * noise from the
encoder for a model with a representation. Writes ``vb_terms.npz``,
``mse_terms.npz`` and ``xstart_mse_terms.npz`` (``[N, T]``, ascending t)
and prints ``{"total_bpd": ...}``. Raw (non-EMA) weights, as the JAX CLI
evaluates them. Across W ranks (``torchrun``) each rank sweeps its
``[rank::W]`` shard of the pool for ``ceil(num_samples / W)`` samples, the
total is the mean of the ranks' means, and the primary writes the gathered
terms (``scripts/nll.py:103-130``).

Usage:
  python -m causaldiffae_torch.nll --ckpt_dir ckpt/morpho --num_samples 64 --batch_size 8
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import create_diffusion
from .data import load_split, synthetic_dataset
from .diffusion import calc_bpd_loop
from .evals.cli import restore_model, start
from .parallel import gather_across_ranks, is_primary, mean_across_ranks, rank, world_size
from .utils import logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=None,
                   help="default morphomnist_causaldae; with --ckpt_dir, the checkpoint's")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--data_dir", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--clip_denoised", action="store_true", default=True)
    p.add_argument("--out_dir", default="causaldiffae_nll")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.batch_size < 1:
        p.error(f"--batch_size {args.batch_size}: must be >= 1")
    return args


def main(argv: Optional[List[str]] = None) -> float:
    args = parse_args(argv)
    device = start(args.device, across_ranks=True)
    cfg, model, _ = restore_model(args.preset, args.ckpt_dir, False, args.seed, device)
    diffusion = create_diffusion(cfg)  # the full process
    if args.synthetic or not args.data_dir:
        pool = synthetic_dataset(cfg.dataset, max(args.num_samples, 64), seed=args.seed,
                                 image_size=cfg.image_size)
    else:
        pool = load_split(cfg.dataset, args.data_dir, "test")
    pool = {k: v[rank()::world_size()] for k, v in pool.items()}  # this rank's shard
    bs = args.batch_size
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    terms = {"vb": [], "mse": [], "xstart_mse": []}
    bpd = []
    n = len(pool["image"])
    per_rank = -(-args.num_samples // world_size())
    for i in range(max(-(-per_rank // bs), 1)):
        t0 = time.perf_counter()
        idx = (np.arange(bs) + i * bs) % n
        x = to(pool["image"][idx])
        y = to(pool["y"][idx]) if cfg.class_cond else None
        c = to(pool["c"][idx]) if cfg.context_cond else None
        with torch.inference_mode():
            z = (model.encode_and_causalize(x, generator=gen(1234 + i))[3]
                 if cfg.rep_cond else None)
            out = calc_bpd_loop(diffusion, lambda xx, tt: model.denoise(xx, tt, y=y, c=c, z=z),
                                x, gen(args.seed + i + (rank() << 32)),
                                clip_denoised=args.clip_denoised)
        bpd.append(out["total_bpd"].cpu().numpy())  # waits for the device
        for k in terms:
            terms[k].append(out[k].cpu().numpy())
        seconds = time.perf_counter() - t0
        logger.log(f"done {(i + 1) * bs} samples: bpd so far = {np.concatenate(bpd).mean():.4f}; "
                   f"batch {seconds:.3f} s ({1e3 * seconds / diffusion.num_timesteps:.2f} ms "
                   f"per UNet call)")
    total = mean_across_ranks(float(np.concatenate(bpd).mean()))
    logger.log(f"total_bpd = {total:.5f}")
    gathered = {name: gather_across_ranks(np.concatenate(parts, 0))
                for name, parts in terms.items()}
    if is_primary():
        os.makedirs(args.out_dir, exist_ok=True)
        for name, value in gathered.items():
            np.savez(os.path.join(args.out_dir, f"{name}_terms.npz"), value)
    print(json.dumps({"total_bpd": total}), flush=True)
    return total


if __name__ == "__main__":
    main()
