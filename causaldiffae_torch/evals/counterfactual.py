"""Counterfactual generation: abduct -> intervene -> regenerate.

Port of ``causaldiffae_tpu/evals/counterfactual.py:46-223``:

1. ENCODE:    (mu, _) = encoder(x); var := ``cfg.reparam_var_scale``
2. INTERVENE: a root variable overwrites mu's block BEFORE the SCM pass; an
   effect variable overwrites z_post's block AFTER it ('auto' picks by the
   adjacency column).
3. SCM:       z_post = g(A^T mu) + mu;  z = z_post + sqrt(var) * rep_noise,
   with the exogenous noise shared between the factual and the
   counterfactual world.
4. ABDUCT:    x_t = q_sample(x, abduction_t, noise) in the respaced process,
   or deterministic DDIM inversion.
5. REGENERATE with the DDIM, DDPM or DPM-Solver++ chain conditioned on z,
   with optional classifier-free guidance w (uncond branch: z = 0).

Each returned function takes the images (NHWC), the conditioning dict, and
optional noise tensors so that tests can inject the JAX package's draws;
noise not given is drawn from the caller's ``torch.Generator`` (on the
images' device). The functions run under ``torch.inference_mode``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from ..diffusion.process import GaussianDiffusion
from ..diffusion.sampling import ddim_reverse_loop, ddim_sample_loop, dpm_solver_pp_loop, p_sample_loop
from ..models.unet import CausalUNet

__all__ = ["make_counterfactual_fn", "make_reconstruct_fn", "make_prior_sample_fn",
           "resolve_sampler"]


def resolve_sampler(use_ddim: bool, sampler: Optional[str] = None,
                    sample_steps: Optional[int] = None):
    """Pick the generation chain: 'ddim' | 'ddpm' | 'dpm++'.

    ``sampler=None`` follows ``use_ddim``. Returns a loop with the common
    ``(diffusion, model_fn, noise, generator, *, clip_denoised, w, uncond_fn)``
    signature.
    """
    if sampler is None:
        sampler = "ddim" if use_ddim else "ddpm"
    if sampler == "dpm++":
        return partial(dpm_solver_pp_loop, num_steps=sample_steps)
    if sample_steps is not None:
        raise ValueError("sample_steps only applies to the dpm++ sampler; "
                         "ddim/ddpm step counts come from timestep_respacing")
    return {"ddim": ddim_sample_loop, "ddpm": p_sample_loop}[sampler]


def _overwrite_block(arr: torch.Tensor, var_index: int, n_vars: int, value) -> torch.Tensor:
    """A copy of ``arr`` with latent block ``var_index`` set to ``value``."""
    d = arr.shape[1] // n_vars
    out = arr.clone()
    block = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    out[:, var_index * d:(var_index + 1) * d] = block.expand(arr.shape[0], d)
    return out


def _randn(shape, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _denoiser(model: CausalUNet, y, c, z):
    def model_fn(xx, tt):
        return model.denoise(xx, tt, y=y, c=c, z=z)
    return model_fn


def make_counterfactual_fn(cfg, model: CausalUNet, diffusion: GaussianDiffusion, *,
                           intervene_var: int, where: str = "auto", use_ddim: bool = True,
                           w: Optional[float] = None, abduction: str = "qsample",
                           sampler: Optional[str] = None, sample_steps: Optional[int] = None):
    """Build ``fn(x, cond, value, generator=None, *, abduction_noise=None,
    rep_noise=None) -> samples``.

    ``value`` is the normalized intervention level broadcast over the
    variable's latent block. 'auto' picks 'pre' for a root variable and
    'post' for one with parents in ``cfg.adjacency`` ('pre' for every
    variable of a model without a causal graph, where the JAX function
    raises). ``rep_noise`` is the
    shared reparameterization noise (shape of mu); ``abduction_noise`` the
    q_sample noise (shape of x).
    """
    if abduction not in ("qsample", "ddim"):
        raise ValueError(f"abduction must be 'qsample' or 'ddim', got {abduction!r}")
    loop = resolve_sampler(use_ddim, sampler, sample_steps)
    n_vars = cfg.n_vars
    if where == "auto":  # without a causal graph every variable is a root
        has_parents = (cfg.adjacency is not None
                       and np.asarray(cfg.adjacency)[:, intervene_var].sum() > 0)
        where = "post" if has_parents else "pre"
    if where not in ("pre", "post"):
        raise ValueError(f"where must be 'auto', 'pre' or 'post', got {where!r}")

    @torch.inference_mode()
    def fn(x, cond: Dict[str, torch.Tensor], value, generator=None, *,
           abduction_noise=None, rep_noise=None):
        B = x.shape[0]
        mu_raw, _ = model.encode(x)
        var = torch.full_like(mu_raw, cfg.reparam_var_scale)
        if rep_noise is None:
            rep_noise = _randn(mu_raw.shape, mu_raw, generator)

        def make_z(intervene: bool) -> torch.Tensor:
            mu = mu_raw
            if intervene and where == "pre":
                mu = _overwrite_block(mu, intervene_var, n_vars, value)
            z_post = model.causalize(mu) if cfg.causal_modeling else mu
            if intervene and where == "post":
                z_post = _overwrite_block(z_post, intervene_var, n_vars, value)
            return z_post + torch.sqrt(var) * rep_noise

        y, c = cond.get("y"), cond.get("c")
        z = make_z(True)
        model_fn = _denoiser(model, y, c, z)
        uncond_fn = _denoiser(model, y, c, torch.zeros_like(z)) if w is not None else None

        if abduction == "qsample":
            t = torch.full((B,), cfg.abduction_t, dtype=torch.long, device=x.device)
            if abduction_noise is None:
                abduction_noise = _randn(x.shape, x, generator)
            x_t = diffusion.q_sample(x, t, abduction_noise)
        else:
            x_t = ddim_reverse_loop(diffusion, _denoiser(model, y, c, make_z(False)), x,
                                    clip_denoised=cfg.clip_denoised, w=w, uncond_fn=uncond_fn)
        return loop(diffusion, model_fn, x_t, generator,
                    clip_denoised=cfg.clip_denoised, w=w, uncond_fn=uncond_fn)

    return fn


def make_reconstruct_fn(cfg, model: CausalUNet, diffusion: GaussianDiffusion, *,
                        use_ddim: bool = True, w: Optional[float] = None,
                        sampler: Optional[str] = None, sample_steps: Optional[int] = None):
    """Identity counterfactual: ``fn(x, cond, generator=None, *,
    abduction_noise=None, rep_noise=None) -> samples``."""
    loop = resolve_sampler(use_ddim, sampler, sample_steps)

    @torch.inference_mode()
    def fn(x, cond, generator=None, *, abduction_noise=None, rep_noise=None):
        B = x.shape[0]
        mu, _ = model.encode(x)
        z_post = model.causalize(mu) if cfg.causal_modeling else mu
        if rep_noise is None:
            rep_noise = _randn(z_post.shape, z_post, generator)
        scale = torch.sqrt(torch.tensor(cfg.reparam_var_scale, dtype=torch.float32))
        z = z_post + scale.to(z_post.device) * rep_noise
        t = torch.full((B,), cfg.abduction_t, dtype=torch.long, device=x.device)
        if abduction_noise is None:
            abduction_noise = _randn(x.shape, x, generator)
        x_t = diffusion.q_sample(x, t, abduction_noise)
        y, c = cond.get("y"), cond.get("c")
        uncond_fn = _denoiser(model, y, c, torch.zeros_like(z)) if w is not None else None
        return loop(diffusion, _denoiser(model, y, c, z), x_t, generator,
                    clip_denoised=cfg.clip_denoised, w=w, uncond_fn=uncond_fn)

    return fn


def make_prior_sample_fn(cfg, model: CausalUNet, diffusion: GaussianDiffusion, *,
                         use_ddim: bool = False, sampler: Optional[str] = None,
                         sample_steps: Optional[int] = None):
    """Prior sampling, z ~ N(0, I) and x_T ~ N(0, I): ``fn(shape, cond,
    generator=None, *, z=None, x_T=None, device="cuda") -> samples``. A model
    without a representation (``rep_cond`` false) takes no z."""
    loop = resolve_sampler(use_ddim, sampler, sample_steps)

    @torch.inference_mode()
    def fn(shape, cond, generator=None, *, z=None, x_T=None, device="cuda"):
        if z is None and cfg.rep_cond:
            z = torch.randn((shape[0], cfg.rep_dim), generator=generator, device=device)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=device)
        model_fn = _denoiser(model, cond.get("y"), cond.get("c"), z)
        return loop(diffusion, model_fn, x_T, generator, clip_denoised=cfg.clip_denoised)

    return fn
