"""Export a trained model as a serving artifact that runs without model code.

Port of ``scripts/export_serving.py``: traces one serving program
(counterfactual generation, reconstruction or prior sampling, the chains
behind ``counterfactual_test`` and ``sample``) with ``torch.export``, the
checkpoint's weights inside, and writes it to one file with a JSON manifest
(``serving.export_artifact``); with ``--aot`` also its AOTInductor package.
The artifact answers without this package's model code:

    fn, manifest = causaldiffae_torch.serving.load_artifact(path)
    images = fn(x, y, value, seed)          # per manifest['inputs']

The attention blocks call the op ``torch.ops.causaldiffae.attention_fwd``
and the norms ``torch.ops.causaldiffae.norm_act_fwd``, so the hand-written
kernels run inside the artifact, under ``--poly_batch`` too (the kernels take
the batch at launch); ``--use_kernels false`` traces the plain attention and
norms instead, and the manifest's ``attention`` says which.
``--verify`` reloads the artifact (and the package) and holds it against
the direct call on the same inputs and draws, within an atol that grows
with the chain (2e-5 per UNet evaluation, the JAX package's rule; wrong
weights or a wrong chain show as O(1) differences).

Usage:
  python -m causaldiffae_torch.export_serving --preset morphomnist_causaldae \\
      --ckpt_dir ckpt/run1 --fn counterfactual --intervene_var 0 --aot \\
      --out artifacts/do_thickness.pt2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from . import serving
from .config import create_diffusion
from .evals import make_counterfactual_fn, make_prior_sample_fn, make_reconstruct_fn
from .evals.cli import restore_model
from .models.attention import AttentionBlock
from .models.layers import GroupNorm32
from .serve import str2bool

__all__ = ["build_serving_fn", "main"]

KINDS = ("counterfactual", "reconstruct", "prior")


class _Program(torch.nn.Module):
    """The model (so its weights are the program's) and the serving body."""

    def __init__(self, model, body):
        super().__init__()
        self.model, self.body = model, body

    def forward(self, *args):
        return self.body(*args)


def build_serving_fn(cfg, model, diffusion, kind: str, *, batch_size: int,
                     intervene_var: int = 0, where: str = "auto", guidance_w=None,
                     abduction: str = "qsample", sampler: Optional[str] = None,
                     sample_steps: Optional[int] = None, device="cuda"):
    """One serving program: ``(module, direct, example_args, names, draws,
    batched_dims)``. ``module`` runs the traceable chain, ``direct`` the
    eager one, on the same positional inputs: the request's ``names`` (x but
    for the prior, y and c as the model conditions on them, the intervention
    value for a counterfactual), then the ``draws`` (the reparameterization
    and abduction noise, or the prior's z and x_T, and DDPM's step noise
    ``[N, B, ...]``). ``batched_dims`` gives each input's batch axis."""
    if kind not in KINDS:
        raise ValueError(f"unknown serving fn kind: {kind}")
    if kind != "prior" and not cfg.rep_cond:
        raise ValueError(f"a {kind} artifact encodes x: {cfg.name} has no representation")
    if sampler is None:
        sampler = "ddim" if cfg.eval_use_ddim else "ddpm"
    B, s, C = batch_size, cfg.image_size, cfg.in_channels
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)
    example = {}
    if kind != "prior":
        example["x"] = zeros(B, s, s, C)
    if cfg.class_cond:
        example["y"] = zeros(B, dtype=torch.long)
    if cfg.context_cond:
        example["c"] = zeros(B, len(cfg.label_scale))
    if kind == "counterfactual":
        example["value"] = zeros()
    names = list(example)
    if kind == "prior":
        if cfg.rep_cond:
            example["z"] = zeros(B, cfg.rep_dim)
        example["x_T"] = zeros(B, s, s, C)
    else:
        example["rep_noise"] = zeros(B, cfg.rep_dim)
        if abduction == "qsample":
            example["abduction_noise"] = zeros(B, s, s, C)
    if sampler == "ddpm":
        example["step_noise"] = zeros(diffusion.num_timesteps, B, s, s, C)
    draws = [n for n in example if n not in names]
    batched = {n: (1 if n == "step_noise" else 0) for n in example if n != "value"}

    common = dict(sampler=sampler, sample_steps=sample_steps)
    if kind == "counterfactual":
        make = lambda tr: make_counterfactual_fn(  # noqa: E731
            cfg, model, diffusion, intervene_var=intervene_var, where=where, w=guidance_w,
            abduction=abduction, traceable=tr, **common)
    elif kind == "reconstruct":
        make = lambda tr: make_reconstruct_fn(cfg, model, diffusion, w=guidance_w,  # noqa: E731
                                              traceable=tr, **common)
    else:
        make = lambda tr: make_prior_sample_fn(cfg, model, diffusion, traceable=tr,  # noqa: E731
                                               **common)

    def body_of(inner):
        def body(*args):
            kw = dict(zip(names + draws, args))
            cond = {k: kw[k] for k in ("y", "c") if k in kw}
            noise = {k: kw[k] for k in draws if k != "x_T"}
            if kind == "counterfactual":
                return inner(kw["x"], cond, kw["value"], **noise)
            if kind == "reconstruct":
                return inner(kw["x"], cond, **noise)
            return inner(tuple(kw["x_T"].shape), cond, x_T=kw["x_T"], device=kw["x_T"].device,
                         **noise)
        return body

    return (_Program(model, body_of(make(True))), body_of(make(False)),
            list(example.values()), names, draws, batched)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=None, help="must match the checkpoint's, when given")
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--out", required=True, help="artifact output path (.pt2)")
    p.add_argument("--fn", choices=KINDS, default="counterfactual")
    p.add_argument("--intervene_var", type=int, default=0)
    p.add_argument("--where", choices=["auto", "pre", "post"], default="auto")
    p.add_argument("--abduction", choices=["qsample", "ddim"], default="qsample")
    p.add_argument("--guidance_w", type=float, default=None)
    p.add_argument("--sampler", choices=["ddim", "ddpm", "dpm++"], default=None)
    p.add_argument("--sample_steps", type=int, default=None, help="dpm++ node budget (e.g. 25)")
    p.add_argument("--batch_size", type=int, default=16, help="the artifact's fixed serving batch")
    p.add_argument("--poly_batch", action="store_true",
                   help="export the batch dimension symbolically: one artifact serves any "
                        "batch size (not for --fn prior)")
    p.add_argument("--aot", action="store_true",
                   help="also write the AOTInductor package <out>" + serving.COMPILED_SUFFIX +
                        " for this card (needs a fixed batch)")
    p.add_argument("--use_ema", type=str2bool, default=False,
                   help="the config's first EMA rate's weights (default: the raw ones)")
    p.add_argument("--use_kernels", type=str2bool, default=None,
                   help="override the checkpoint's config (false: the plain attention "
                        "and norms)")
    p.add_argument("--verify", type=str2bool, default=True,
                   help="reload the artifact and hold it against the direct call")
    p.add_argument("--verify_atol", type=float, default=None,
                   help="default max(1e-5, 2e-5 x the chain's UNet evaluations)")
    p.add_argument("--seed", type=int, default=0, help="the draws of the verify call")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.poly_batch and args.fn == "prior":
        p.error("--poly_batch needs a batched input; the prior sampler's shape is fixed")
    if args.aot and args.poly_batch:
        p.error("--aot needs concrete shapes; drop --poly_batch")
    return args


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to export on the CPU")
    cfg, model, step = restore_model(args.preset, args.ckpt_dir, args.use_ema, 0, args.device)
    if args.use_kernels is not None:
        cfg = cfg.replace(use_kernels=args.use_kernels)
        for blk in model.modules():
            if isinstance(blk, (AttentionBlock, GroupNorm32)):
                blk.use_kernels = args.use_kernels
    model.requires_grad_(False)   # else the trace records autograd through the loop
    diffusion = create_diffusion(cfg, eval_mode=True)
    diffusion.arrays_on(args.device)
    module, direct, example, names, draws, batched = build_serving_fn(
        cfg, model, diffusion, args.fn, batch_size=args.batch_size,
        intervene_var=args.intervene_var, where=args.where, guidance_w=args.guidance_w,
        abduction=args.abduction, sampler=args.sampler, sample_steps=args.sample_steps,
        device=args.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        manifest, ep = serving.export_artifact(module, example, args.out, {
            "preset": cfg.name, "fn": args.fn, "intervene_var": args.intervene_var,
            "where": args.where, "abduction": args.abduction, "guidance_w": args.guidance_w,
            "sampler": args.sampler or ("ddim" if cfg.eval_use_ddim else "ddpm"),
            "sample_steps": args.sample_steps,
            "batch_size": "polymorphic" if args.poly_batch else args.batch_size,
            "checkpoint_step": step, "use_ema": args.use_ema,
        }, names=names, draws=draws, batched_dims=batched, poly_batch=args.poly_batch)
    manifest["export_s"] = time.perf_counter() - t0
    _log(f"wrote {args.out} ({manifest['bytes']} bytes, device {manifest['device']}, "
         f"attention {manifest['attention']}: {manifest['attention_nodes']} op nodes) in "
         f"{manifest['export_s']:.1f} s")
    compiled = None
    if args.aot:
        compiled = serving.export_compiled_artifact(ep, args.out + serving.COMPILED_SUFFIX)
        manifest["aot"] = compiled
        _log(f"wrote {args.out + serving.COMPILED_SUFFIX} ({compiled['bytes']} bytes, "
             f"{compiled.get('card', compiled['device_type'])}) in {compiled['compile_s']:.1f} s")
    if args.verify:
        manifest["verify"] = verify(args, manifest, direct, example, names, diffusion,
                                    compiled is not None)
    # the manifest records how the artifact was made and checked
    Path(args.out + serving.MANIFEST_SUFFIX).write_text(json.dumps(manifest, indent=2))
    print(f"exported {args.fn} -> {args.out}", flush=True)
    return manifest


def verify(args, manifest, direct, example, names, diffusion, compiled: bool) -> List[dict]:
    """Reload the artifact (and the package) and hold each against the direct
    call on zero requests and the draws of ``--seed``: at the fixed batch, or
    at 2 and ``--batch_size`` under ``--poly_batch``. Exits past the atol."""
    n_evals = args.sample_steps or diffusion.num_timesteps
    atol = args.verify_atol if args.verify_atol is not None else max(1e-5, 2e-5 * n_evals)
    routes = [("artifact", serving.load_artifact(args.out)[0])]
    if compiled:
        program = serving.load_compiled_artifact(args.out + serving.COMPILED_SUFFIX)
        routes.append(("AOT package", serving.load_artifact(args.out, program)[0]))
    out = []
    for b in ((2, args.batch_size) if args.poly_batch else (args.batch_size,)):
        inputs = [torch.zeros((b, *t.shape[1:]), dtype=t.dtype, device=t.device) if t.dim()
                  else t for t in example[:len(names)]]
        draws = serving.draw_inputs(manifest, b, args.seed, inputs[0].device if inputs
                                    else example[0].device)
        with torch.inference_mode():
            want = direct(*inputs, *draws).float().cpu().numpy()
        for route, fn in routes:
            got = fn(*inputs, args.seed).float().cpu().numpy()
            delta = float(np.abs(want - got).max())
            _log(f"verify {route} (batch {b}): max|direct - artifact| = {delta:.3e} "
                 f"(atol {atol:.1e}, {n_evals} UNet evals)")
            out.append({"route": route, "batch": b, "max_abs": delta, "atol": atol})
            if not (np.isfinite(got).all() and delta <= atol):
                raise SystemExit(f"{route} does not reproduce the direct call")
    return out


if __name__ == "__main__":
    main()
