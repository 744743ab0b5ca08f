"""Counterfactual evaluation: effectiveness MAE, FID and disentanglement.

The port's counterpart of ``scripts/counterfactual_test.py``, with the same
flags (and ``--device``). Modes: ``causaldae`` intervenes through the SCM
latents (roots on mu before the SCM pass, effects on z_post after it, or as
``--where`` says), ``diffae`` on mu blocks without the SCM, ``conditional``
on the context vector ``c``. The model is the latest checkpoint in
``--ckpt_dir`` (with the config it trained, raw weights unless
``--use_ema true``), else the preset with weights made from ``--seed``.

Branches:

- default, effectiveness: anti-causal probes are loaded from
  ``--classifier_dir`` (the port's or the JAX package's
  ``classifier_<dataset>_<var>.pkl``, or a reference
  ``classifier_<var>_best.pth``) or trained on the training pool and saved
  there; a reconstruction grid; then for every variable, batches of do()
  requests at random values, each scored by every probe against the
  ground-truth SCM: MAE per factor. With ``--compute_fid``, the Frechet
  distance between real test images and the counterfactuals. Writes
  ``samples_do_<var>.npz`` (stamped with the replay plan, for
  ``rescore_counterfactuals``) and ``grid_do_<var>.png``.
- ``--eval_disentanglement``: encode the pools and report DCI (needs
  scikit-learn), IRS and MCC.

The requests and values come from ``numpy.random.RandomState(seed)`` in the
JAX CLI's order (``interventions.intervention_plan``), so a run replays the
JAX CLI's requests and ground truth; the chains' noise comes from torch
generators. Single process. Prints one JSON line with the JAX CLI's keys;
log lines go to stderr.

Usage:
  python -m causaldiffae_torch.counterfactual_test --ckpt_dir ckpt/morpho --synthetic \\
      --num_samples 64 --batch_size 16 --out_dir eval/morpho --compute_fid
  python -m causaldiffae_torch.counterfactual_test --preset pendulum_causaldae \\
      --sampler dpm++ --sample_steps 25 ... --device cpu
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import DATA_SCALES, create_diffusion
from .data import load_split, synthetic_dataset
from .evals import (ClassifierTrainer, classifier_predict_fn, compute_dci, compute_irs,
                    load_classifier, make_counterfactual_fn, make_reconstruct_fn, mcc)
from .evals.cli import restore_model, start
from .evals.quality import FID, default_feature_fn
from .interventions import INTERVENTION_RANGES, VAR_NAMES, intervention_plan
from .serve import context_counterfactual_fn, str2bool
from .utils import logger
from .utils.images import save_grid


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=None,
                   help="default morphomnist_causaldae; with --ckpt_dir, the checkpoint's")
    p.add_argument("--mode", choices=["causaldae", "diffae", "conditional"], default="causaldae")
    p.add_argument("--ckpt_dir", default=None)
    # the reference evaluates the raw weights (model014000.pt), not the EMA
    p.add_argument("--use_ema", type=str2bool, default=False)
    p.add_argument("--data_dir", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--guidance_w", type=float, default=None)
    p.add_argument("--eval_disentanglement", action="store_true")
    p.add_argument("--classifier_dir", default="")
    p.add_argument("--out_dir", default="causaldiffae_eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_fid", action="store_true",
                   help="FID(real test images, counterfactuals) over the first probe's trunk "
                        "features, or Inception's with --inception_weights")
    p.add_argument("--inception_weights", default="",
                   help="local InceptionV3 state dict for published-comparable FID")
    p.add_argument("--traversal", action="store_true",
                   help="save per-variable latent-traversal grids")
    p.add_argument("--no_recon", action="store_true", help="skip the reconstruction grid")
    p.add_argument("--abduction", choices=["qsample", "ddim"], default="qsample")
    p.add_argument("--where", choices=["auto", "pre", "post"], default="auto")
    p.add_argument("--clf_epochs", type=int, default=100)
    p.add_argument("--sampler", choices=["ddim", "ddpm", "dpm++"], default=None,
                   help="default follows the preset's eval_use_ddim")
    p.add_argument("--sample_steps", type=int, default=None, help="dpm++ node budget")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.sample_steps is not None and args.sampler != "dpm++":
        p.error("--sample_steps only applies to --sampler dpm++; "
                "ddim/ddpm step counts come from timestep_respacing")
    if args.batch_size < 1:
        p.error(f"--batch_size {args.batch_size}: must be >= 1")
    return args


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    start(args.device)
    if args.eval_disentanglement and importlib.util.find_spec("sklearn") is None:
        raise SystemExit("--eval_disentanglement needs scikit-learn (DCI's boosted trees)")
    cfg, model, _ = restore_model(args.preset, args.ckpt_dir, args.use_ema, args.seed,
                                  args.device)
    if args.mode == "diffae":
        cfg = cfg.replace(causal_modeling=False, masking=False)
    if args.guidance_w is not None:
        cfg = cfg.replace(guidance_w=args.guidance_w)
    num_samples = args.num_samples or cfg.num_samples
    os.makedirs(args.out_dir, exist_ok=True)
    synthetic = args.synthetic or not args.data_dir
    if synthetic:
        test_pool = synthetic_dataset(cfg.dataset, max(num_samples, 512), seed=args.seed + 99,
                                      image_size=cfg.image_size)
        train_pool = synthetic_dataset(cfg.dataset, 2048, seed=args.seed + 1,
                                       image_size=cfg.image_size)
    else:
        train_pool = load_split(cfg.dataset, args.data_dir, "train")
        test_pool = load_split(cfg.dataset, args.data_dir, "test")
    if args.eval_disentanglement:
        result = disentanglement(args, cfg, model, train_pool, test_pool)
    else:
        result = effectiveness(args, cfg, model, train_pool, test_pool, num_samples, synthetic)
    print(json.dumps(result), flush=True)
    return result


def disentanglement(args, cfg, model, train_pool, test_pool) -> dict:
    """DCI over the encoded pools, then IRS and MCC on the test pool."""
    bs, device = args.batch_size, args.device

    @torch.inference_mode()
    def encode_pool(pool, seed):
        reps = []
        for i in range(0, len(pool["image"]) - bs + 1, bs):
            mu, _ = model.encode(torch.from_numpy(pool["image"][i:i + bs]).to(device))
            z_post = model.causalize(mu) if cfg.causal_modeling else mu
            noise = torch.randn(z_post.shape, generator=_generator(seed + i, device),
                                device=device)
            reps.append((z_post + math.sqrt(cfg.reparam_var_scale) * noise).cpu().numpy())
        return np.concatenate(reps, 0)

    rep_train = encode_pool(train_pool, 0)
    rep_test = encode_pool(test_pool, 10_000)
    y_train = train_pool["c"][: len(rep_train)]
    y_test = test_pool["c"][: len(rep_test)]
    scores, _, _ = compute_dci(rep_train.T, y_train.T, rep_test.T, y_test.T)
    result = {k: float(v) for k, v in scores.items()}
    # IRS groups samples by equal factor values, degenerate for continuous
    # factors, so they are binned into 20 quantiles first; MCC needs equal
    # dims, so the latent is reduced to its per-variable block means
    y_np = np.asarray(y_test)
    y_binned = np.stack([np.digitize(col, np.quantile(col, np.linspace(0, 1, 21)[1:-1]))
                         for col in y_np.T], axis=1)
    result["IRS"] = float(compute_irs(rep_test.T, y_binned.T)["IRS"])
    d_block = rep_test.shape[1] // cfg.n_vars
    block_means = rep_test.reshape(len(rep_test), cfg.n_vars, d_block).mean(-1)
    result["MCC_block_mean"] = mcc(y_np, block_means)
    logger.log(f"disentanglement: {result}")
    return result


def load_or_train_probes(args, cfg, train_pool):
    """One probe per factor: loaded from the classifier directory, else
    trained on a shuffled 90/10 split of the training pool and saved there.
    Returns [(name, model, best validation MSE)]."""
    dataset, device = cfg.dataset, args.device
    cdir = args.classifier_dir or args.out_dir
    probes = []
    for f, name in enumerate(VAR_NAMES[dataset]):
        path = os.path.join(cdir, f"classifier_{dataset}_{name}.pkl")
        ref_path = os.path.join(cdir, f"classifier_{name.replace('_', '')}_best.pth")
        if not os.path.exists(path) and os.path.exists(ref_path):
            logger.log(f"importing reference torch classifier {ref_path}")
            path = ref_path
        if not os.path.exists(path):
            logger.log(f"training anti-causal classifier for {name}...")
            tr = ClassifierTrainer(dataset, f, cfg.n_vars, seed=args.seed, device=device)
            n = len(train_pool["image"])
            # shuffled before the split: real archives can be sorted by index
            perm = np.random.RandomState(args.seed + 17).permutation(n)
            cut = int(n * 0.9)
            tr.fit({k: v[perm[:cut]] for k, v in train_pool.items()},
                   {k: v[perm[cut:]] for k, v in train_pool.items()},
                   epochs=args.clf_epochs, batch_size=64, log_every=10)
            tr.save_best(path)
        model, meta = load_classifier(path, cfg.n_vars, cfg.image_size, cfg.in_channels,
                                      device=device)
        probes.append((name, model, float(meta.get("best_val", float("nan")))))
    return probes


def effectiveness(args, cfg, model, train_pool, test_pool, num_samples, synthetic) -> dict:
    """Probes, reconstruction, traversals and do() batches for every
    variable; MAE per factor, the probes' validation MSE and FID."""
    dataset, device, out_dir = cfg.dataset, args.device, args.out_dir
    diffusion = create_diffusion(cfg, eval_mode=True)
    probes = load_or_train_probes(args, cfg, train_pool)
    predictors = [classifier_predict_fn(m) for _, m, _ in probes]
    fid = None
    if args.compute_fid:
        fid = FID(default_feature_fn(probes[0][1], args.inception_weights or None, device))
        fid.update(np.clip(test_pool["image"][:num_samples * 2], 0, 1), real=True)

    n_batches = max(num_samples // args.batch_size, 1)
    probe_sel, plan = intervention_plan(dataset, test_pool["c"], seed=args.seed,
                                        batch_size=args.batch_size, n_batches=n_batches)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def conditioning(sel):
        cond = {}
        if cfg.class_cond:
            cond["y"] = to(test_pool["y"][sel])
        if cfg.context_cond:
            cond["c"] = to(test_pool["c"][sel])
        return cond

    probe_x, probe_cond = to(test_pool["image"][probe_sel]), conditioning(probe_sel)
    w = cfg.guidance_w
    if not args.no_recon and args.mode != "conditional":
        # originals (top row) above their reconstructions
        recon_fn = make_reconstruct_fn(cfg, model, diffusion, use_ddim=cfg.eval_use_ddim, w=w,
                                       sampler=args.sampler, sample_steps=args.sample_steps)
        t0 = time.perf_counter()
        recon = recon_fn(probe_x, probe_cond, _generator(args.seed + 7, device)).cpu().numpy()
        original = test_pool["image"][probe_sel]
        k = min(8, len(recon))
        save_grid(np.concatenate([original[:k], recon[:k]], 0),
                  os.path.join(out_dir, "reconstructions.png"), ncol=k)
        np.savez(os.path.join(out_dir, "reconstructions.npz"), original=original[:k],
                 recon=recon[:k])
        logger.log(f"reconstruction grid saved ({k} pairs) in {time.perf_counter() - t0:.3f} s, "
                   f"mae={np.abs(recon[:k] - original[:k]).mean():.4f}")

    scale = np.asarray(DATA_SCALES[dataset])
    mae = {name: [] for name, _, _ in probes}
    for var_idx, name in enumerate(VAR_NAMES[dataset]):
        if args.mode == "conditional":
            cf_fn = context_counterfactual_fn(cfg, model, diffusion, intervene_var=var_idx,
                                              sampler=args.sampler,
                                              sample_steps=args.sample_steps)
        else:
            cf_fn = make_counterfactual_fn(
                cfg, model, diffusion, intervene_var=var_idx,
                where="pre" if args.mode == "diffae" else args.where,
                use_ddim=cfg.eval_use_ddim, w=w, abduction=args.abduction,
                sampler=args.sampler, sample_steps=args.sample_steps)
        if args.traversal and args.mode != "conditional":
            # sweep the variable over its normalised range on the probe batch,
            # one row per level, the same noise for every level
            lo, hi = ((r - scale[var_idx, 0]) / scale[var_idx, 1]
                      for r in INTERVENTION_RANGES[dataset][var_idx])
            k8 = min(8, len(probe_x))
            rows = [cf_fn(probe_x, probe_cond, float(val),
                          _generator(args.seed + 31, device)).cpu().numpy()[:k8]
                    for val in np.linspace(lo, hi, 8)]
            save_grid(np.concatenate(rows, 0), os.path.join(out_dir, f"traversal_{name}.png"),
                      ncol=k8)
            logger.log(f"traversal grid for {name}: 8 levels x {k8} samples")
        grids = []
        for b, req in enumerate(plan[var_idx]):
            t0 = time.perf_counter()
            x = to(test_pool["image"][req.sel])
            gen = _generator(args.seed * 1000 + var_idx * 100 + b, device)
            samples = cf_fn(x, conditioning(req.sel), req.value, gen)
            grids.append(samples.cpu().numpy())  # waits for the device
            latency = time.perf_counter() - t0
            clipped = samples.clamp(0, 1)
            for f, ((factor, _, _), pred) in enumerate(zip(probes, predictors)):
                out = pred(clipped).cpu().numpy()
                mae[factor].append(np.abs(out - req.gt_norm[:, f]).mean())
            logger.log(f"do({name} = {req.raw_value:.4g}) batch {b}: {latency:.3f} s")
        allg = np.concatenate(grids, 0)
        if fid is not None:
            fid.update(np.clip(allg, 0, 1), real=False)
        # the generation plan's stamps, which rescore_counterfactuals checks
        np.savez(os.path.join(out_dir, f"samples_do_{name}.npz"), samples=allg, seed=args.seed,
                 batch_size=args.batch_size, num_samples=num_samples, process_count=1,
                 synthetic_pool=int(synthetic))
        save_grid(allg[:64], os.path.join(out_dir, f"grid_do_{name}.png"))
        logger.log(f"do({name}): saved {len(allg)} samples")

    # each MAE ships with its probe's calibration (best validation MSE)
    result = {f"mae_{k}": float(np.mean(v)) for k, v in mae.items() if v}
    for name, _, best_val in probes:
        result[f"clf_val_mse_{name}"] = best_val
    if fid is not None:
        result["fid"] = fid.compute()
        logger.log(f"FID (counterfactuals vs real): {result['fid']:.3f}")
    logger.log(f"effectiveness MAE: {result}")
    return result


if __name__ == "__main__":
    main()
