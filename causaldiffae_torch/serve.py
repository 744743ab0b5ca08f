"""Serve counterfactual generation requests with the port.

The port's counterpart of counterfactual generation as
``scripts/counterfactual_test.py`` and ``scripts/serve.py`` drive it: build
the model from a preset with weights from ``--init_from`` (an ``.npz`` of
flax variables or a reference-key ``.pt``) or a seeded init, or from
``--ckpt_dir``: the latest checkpoint the train CLI saved there, with the
model and the diffusion of the config it was trained with and the weights
of that config's first EMA rate unless ``--use_ema false``. Read requests from an ``.npz`` or
make ``--synthetic N`` of them, and answer them batch by batch with the DDIM
or DPM-Solver++ chain. Prints one JSON line per batch with its latency.

A request holds ``x`` (NHWC in [-1, 1]) and what the preset conditions on:
class labels ``y`` for the class-conditional presets, the context ``c``
(normalised labels) for the ``*_conditional`` ones. A model with a
representation answers ``do(var = value)`` on its latent (``where``: 'auto'
picks 'pre' for a root variable or a model without a causal graph, 'post'
for an effect); a context model answers it on ``c[:, var]``.

Usage:
  python -m causaldiffae_torch.serve --preset circuit_causaldae --ckpt_dir ckpt/circuit \\
      --synthetic 32 --batch 16 --intervene_var 0 --value 1.0
  python -m causaldiffae_torch.serve ... --input requests.npz --out answers.npz \\
      --sampler dpm++ --sample_steps 25
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .config import DATA_SCALES, Config, create_diffusion, create_model, get_config
from .data import synthetic_dataset
from .evals.counterfactual import make_counterfactual_fn, resolve_sampler
from .ops import prepare
from .training.checkpoint import CheckpointManager
from .training.state import ema_rates
from .utils.weights import load_weights


def str2bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "t", "y")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=None,
                   help="default morphomnist_causaldae; with --ckpt_dir, the checkpoint's")
    p.add_argument("--ckpt_dir", default="",
                   help="answer from the latest checkpoint the train CLI saved here, "
                        "with the config it was trained with")
    p.add_argument("--use_ema", type=str2bool, default=True,
                   help="with --ckpt_dir: the first EMA rate's weights (default), else the raw ones")
    p.add_argument("--init_from", default="",
                   help=".npz of flax variables or reference-key .pt (default: seeded init)")
    p.add_argument("--input", default="",
                   help=".npz with x [N,H,W,C], and y [N] / c [N,n] as the preset needs them")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="serve N synthetic requests made from --seed instead of --input")
    p.add_argument("--intervene_var", type=int, default=0)
    p.add_argument("--value", type=float, required=True,
                   help="normalized intervention level for the variable's latent block")
    p.add_argument("--where", choices=("auto", "pre", "post"), default="auto")
    p.add_argument("--sampler", choices=("ddim", "dpm++"), default="ddim")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="dpm++ node budget (ddim runs the preset's respacing)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="", help="write the answers to this .npz")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error(f"--batch {args.batch}: must be >= 1")
    if bool(args.input) == bool(args.synthetic):
        p.error("give exactly one of --input / --synthetic")
    if args.sampler == "ddim" and args.sample_steps is not None:
        p.error("--sample_steps applies to --sampler dpm++ only")
    if args.ckpt_dir and args.init_from:
        p.error("give at most one of --ckpt_dir / --init_from")
    return args


def build_model(cfg, init_from: str, seed: int, device: str) -> torch.nn.Module:
    """The preset's model in eval mode, with weights from ``init_from`` or a seeded init."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(cfg, device="cpu")
    if init_from:
        load_weights(cfg, model, init_from)
    return model.to(device).eval()


def load_checkpoint(ckpt_dir: str, use_ema: bool = True, device: str = "cuda"):
    """The model of the latest checkpoint in ``ckpt_dir``, built from the
    config it was trained with (the train CLI's overrides included), in eval
    mode on ``device``: its BatchNorm buffers and, with ``use_ema``, the
    config's first EMA rate's weights (as ``eval_params`` picks them), else
    the raw ones. Returns (config, model, step)."""
    step = CheckpointManager(ckpt_dir).latest_step() if os.path.isdir(ckpt_dir) else None
    if step is None:
        raise SystemExit(f"--ckpt_dir {ckpt_dir}: no checkpoint")
    saved = CheckpointManager(ckpt_dir).load(step)
    if saved.get("config") is None:
        raise SystemExit(f"--ckpt_dir {ckpt_dir}: step {step} records no config")
    cfg = Config(**saved["config"])
    model = build_model(cfg, "", cfg.seed, device)
    weights = dict(saved["model"])
    if use_ema:
        weights.update(saved["ema"][ema_rates(cfg)[0]])
    model.load_state_dict(weights)
    return cfg, model, step


def conditioning_keys(cfg) -> List[str]:
    """What a request of ``cfg``'s model holds besides ``x``."""
    return (["y"] if cfg.class_cond else []) + (["c"] if cfg.context_cond else [])


def synthetic_requests(cfg, n: int, seed: int) -> Dict[str, np.ndarray]:
    """``n`` requests made from ``seed``: images in [-1, 1], with class labels
    and the context (from the synthetic pool of ``cfg.dataset``) as the
    model conditions on them."""
    rng = np.random.RandomState(seed)
    s = cfg.image_size
    req = {"x": rng.uniform(-1.0, 1.0, (n, s, s, cfg.in_channels)).astype(np.float32)}
    if cfg.class_cond:
        req["y"] = (np.arange(n) % 10).astype(np.int64)
    if cfg.context_cond:
        # the labels are drawn before the render, so a small render gives the same c
        req["c"] = synthetic_dataset(cfg.dataset, n, seed=seed, image_size=8)["c"]
    return req


def load_requests(cfg, path: str) -> Dict[str, np.ndarray]:
    """The arrays of ``path`` that ``cfg``'s model takes; raises on a missing one."""
    keys = ["x"] + conditioning_keys(cfg)
    with np.load(path) as z:
        missing = [k for k in keys if k not in z.files]
        if missing:
            raise SystemExit(f"--input {path}: {cfg.name} needs arrays {keys}, missing {missing}")
        req = {k: z[k] for k in keys}
    if len(req["x"]) == 0:
        raise SystemExit(f"--input {path}: no requests")
    if any(len(v) != len(req["x"]) for v in req.values()):
        raise SystemExit(f"--input {path}: arrays {keys} differ in length")
    return req


def unet_calls_per_chain(cfg, diffusion, sampler: str, sample_steps: Optional[int]) -> int:
    """UNet forwards one chain makes (twice that under guidance)."""
    from .diffusion.sampling import dpm_solver_pp_nodes

    if sampler == "dpm++":
        n = len(dpm_solver_pp_nodes(diffusion, 2, sample_steps)[0])
    else:
        n = diffusion.num_timesteps
    return n * (2 if cfg.guidance_w is not None else 1)


def context_counterfactual_fn(cfg, model, diffusion, *, intervene_var: int,
                              sampler: str = "ddim", sample_steps: Optional[int] = None):
    """``fn(x, cond, value, generator=None, *, abduction_noise=None)`` for a
    model conditioned on the context: ``c[:, intervene_var] := value``,
    abduct by ``q_sample`` at ``abduction_t`` (with ``abduction_noise``, of
    the shape of x, else a draw from ``generator``), regenerate conditioned
    on the edited context (the conditional mode of
    ``scripts/counterfactual_test.py``)."""
    loop = resolve_sampler(cfg.eval_use_ddim, sampler, sample_steps)

    @torch.inference_mode()
    def fn(x, cond: Dict[str, torch.Tensor], value, generator=None, *, abduction_noise=None):
        c = cond["c"].clone()
        c[:, intervene_var] = value
        t = torch.full((x.shape[0],), cfg.abduction_t, dtype=torch.long, device=x.device)
        if abduction_noise is None:
            abduction_noise = torch.randn(x.shape, generator=generator, device=x.device,
                                          dtype=x.dtype)
        x_t = diffusion.q_sample(x, t, abduction_noise)
        y = cond.get("y")
        return loop(diffusion, lambda xx, tt: model.denoise(xx, tt, y=y, c=c), x_t, generator,
                    clip_denoised=cfg.clip_denoised)

    return fn


def serve(cfg, model, requests: Dict[str, np.ndarray], *, intervene_var: int, value: float,
          where: str = "auto", sampler: str = "ddim", sample_steps: Optional[int] = None,
          batch: int = 16, seed: int = 0, device: str = "cuda") -> Iterator[dict]:
    """Answer ``requests`` batch by batch; yields one record per batch.

    Each record holds the batch's answers (``samples``, NHWC numpy) and its
    latency, timed on the host clock around work that ends in a device
    synchronisation.
    """
    diffusion = create_diffusion(cfg, eval_mode=True)
    if cfg.rep_cond:
        fn = make_counterfactual_fn(cfg, model, diffusion, intervene_var=intervene_var,
                                    where=where, w=cfg.guidance_w, sampler=sampler,
                                    sample_steps=sample_steps)
    else:
        fn = context_counterfactual_fn(cfg, model, diffusion, intervene_var=intervene_var,
                                       sampler=sampler, sample_steps=sample_steps)
    calls = unet_calls_per_chain(cfg, diffusion, sampler, sample_steps)
    n = len(requests["x"])
    for i, lo in enumerate(range(0, n, batch)):
        t0 = time.perf_counter()
        x = torch.from_numpy(requests["x"][lo:lo + batch]).to(device)
        cond = {k: torch.from_numpy(requests[k][lo:lo + batch]).to(device)
                for k in conditioning_keys(cfg)}
        gen = torch.Generator(device=device).manual_seed(seed + lo)
        out = fn(x, cond, value, gen)
        samples = out.cpu().numpy()  # waits for the device
        latency = time.perf_counter() - t0
        yield {"batch": i, "size": len(samples), "sampler": sampler, "unet_calls": calls,
               "latency_s": latency, "imgs_per_s": len(samples) / latency,
               "finite": bool(np.isfinite(samples).all()), "samples": samples}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to serve on the CPU")
    if args.ckpt_dir:
        cfg, model, step = load_checkpoint(args.ckpt_dir, args.use_ema, args.device)
        if args.preset not in (None, cfg.name):
            raise SystemExit(f"--preset {args.preset}: the checkpoint in {args.ckpt_dir} "
                             f"was trained as {cfg.name}")
        print(f"answering from {args.ckpt_dir} step {step} "
              f"({'EMA' if args.use_ema else 'raw'} weights)", file=sys.stderr, flush=True)
    else:
        cfg = get_config(args.preset or "morphomnist_causaldae")
        model = build_model(cfg, args.init_from, args.seed, args.device)
    n_vars = cfg.n_vars if cfg.rep_cond else len(DATA_SCALES[cfg.dataset])
    if not 0 <= args.intervene_var < n_vars:
        raise SystemExit(f"--intervene_var {args.intervene_var}: {cfg.name} has {n_vars} variables")
    prepare(args.device, cfg.use_kernels, cfg.use_bf16)  # at start-up, not inside the first batch
    requests = (synthetic_requests(cfg, args.synthetic, args.seed) if args.synthetic
                else load_requests(cfg, args.input))
    records, answers = [], []
    for rec in serve(cfg, model, requests, intervene_var=args.intervene_var, value=args.value,
                     where=args.where, sampler=args.sampler, sample_steps=args.sample_steps,
                     batch=args.batch, seed=args.seed, device=args.device):
        answers.append(rec.pop("samples"))
        rec["device"] = args.device
        print(json.dumps(rec), flush=True)
        records.append(rec)
    if args.out:
        np.savez(args.out, samples=np.concatenate(answers, 0))
    return records


if __name__ == "__main__":
    main()
