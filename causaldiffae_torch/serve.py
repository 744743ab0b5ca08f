"""Serve counterfactual generation requests with the port.

The port's counterpart of counterfactual generation as
``scripts/counterfactual_test.py`` and ``scripts/serve.py`` drive it: build
the model from a preset, take weights from ``--init_from`` (an ``.npz`` of
flax variables or a reference-key ``.pt``) or a seeded init, read requests
(``x`` NHWC in [-1, 1], ``y`` class labels) from an ``.npz`` or make
``--synthetic N`` of them, and answer them batch by batch with the DDIM or
DPM-Solver++ chain. Prints one JSON line per batch with its latency.

Usage:
  python -m causaldiffae_torch.serve --preset morphomnist_causaldae \\
      --synthetic 32 --batch 16 --intervene_var 0 --value 1.0
  python -m causaldiffae_torch.serve ... --input requests.npz --out answers.npz \\
      --sampler dpm++ --sample_steps 25
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .config import create_diffusion, create_model, get_config
from .evals.counterfactual import make_counterfactual_fn
from .ops import _build
from .utils.weights import load_weights


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="morphomnist_causaldae")
    p.add_argument("--init_from", default="",
                   help=".npz of flax variables or reference-key .pt (default: seeded init)")
    p.add_argument("--input", default="", help=".npz with x [N,H,W,C] and y [N]")
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
    return args


def build_model(cfg, init_from: str, seed: int, device: str) -> torch.nn.Module:
    """The preset's model in eval mode, with weights from ``init_from`` or a seeded init."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(cfg, device="cpu")
    if init_from:
        load_weights(cfg, model, init_from)
    return model.to(device).eval()


def synthetic_requests(cfg, n: int, seed: int) -> Dict[str, np.ndarray]:
    """``n`` requests made from ``seed``: images in [-1, 1] and class labels."""
    rng = np.random.RandomState(seed)
    s = cfg.image_size
    x = rng.uniform(-1.0, 1.0, (n, s, s, cfg.in_channels)).astype(np.float32)
    return {"x": x, "y": (np.arange(n) % 10).astype(np.int64)}


def load_requests(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        if "x" not in z.files:
            raise SystemExit(f"--input {path}: needs an array named x [N, H, W, C]")
        req = {k: z[k] for k in ("x", "y", "c") if k in z.files}
    if len(req["x"]) == 0:
        raise SystemExit(f"--input {path}: no requests")
    return req


def unet_calls_per_chain(cfg, diffusion, sampler: str, sample_steps: Optional[int]) -> int:
    """UNet forwards one chain makes (twice that under guidance)."""
    from .diffusion.sampling import dpm_solver_pp_nodes

    if sampler == "dpm++":
        n = len(dpm_solver_pp_nodes(diffusion, 2, sample_steps)[0])
    else:
        n = diffusion.num_timesteps
    return n * (2 if cfg.guidance_w is not None else 1)


def serve(cfg, model, requests: Dict[str, np.ndarray], *, intervene_var: int, value: float,
          where: str = "auto", sampler: str = "ddim", sample_steps: Optional[int] = None,
          batch: int = 16, seed: int = 0, device: str = "cuda") -> Iterator[dict]:
    """Answer ``requests`` batch by batch; yields one record per batch.

    Each record holds the batch's answers (``samples``, NHWC numpy) and its
    latency, timed on the host clock around work that ends in a device
    synchronisation.
    """
    diffusion = create_diffusion(cfg, eval_mode=True)
    fn = make_counterfactual_fn(cfg, model, diffusion, intervene_var=intervene_var,
                                where=where, w=cfg.guidance_w, sampler=sampler,
                                sample_steps=sample_steps)
    calls = unet_calls_per_chain(cfg, diffusion, sampler, sample_steps)
    n = len(requests["x"])
    for i, lo in enumerate(range(0, n, batch)):
        t0 = time.perf_counter()
        x = torch.from_numpy(requests["x"][lo:lo + batch]).to(device)
        cond = {k: torch.from_numpy(requests[k][lo:lo + batch]).to(device)
                for k in ("y", "c") if k in requests}
        gen = torch.Generator(device=device).manual_seed(seed + lo)
        out = fn(x, cond, value, gen)
        samples = out.cpu().numpy()  # waits for the device
        latency = time.perf_counter() - t0
        yield {"batch": i, "size": len(samples), "sampler": sampler, "unet_calls": calls,
               "latency_s": latency, "imgs_per_s": len(samples) / latency,
               "finite": bool(np.isfinite(samples).all()), "samples": samples}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    cfg = get_config(args.preset)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu to serve on the CPU")
        if cfg.use_kernels and cfg.use_bf16:
            _build.build("attention_fwd")  # at start-up, not inside the first batch
    model = build_model(cfg, args.init_from, args.seed, args.device)
    requests = (synthetic_requests(cfg, args.synthetic, args.seed) if args.synthetic
                else load_requests(args.input))
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
