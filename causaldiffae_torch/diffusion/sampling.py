"""Sampling chains: Python loops over the single reverse steps.

Port of ``causaldiffae_tpu/diffusion/sampling.py:36-250``. The JAX package
runs each chain as one ``lax.scan``; here each chain is a Python loop of
eager model calls. The per-step timestep is a device tensor built once per
step, so the loop does not wait on the device. ``calc_bpd_loop`` belongs to
the training/NLL slice and is not here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .process import GaussianDiffusion

__all__ = [
    "p_sample_loop",
    "ddim_sample_loop",
    "ddim_reverse_loop",
    "dpm_solver_pp_loop",
]


def _full_t(t: int, B: int, device) -> torch.Tensor:
    return torch.full((B,), t, dtype=torch.long, device=device)


def p_sample_loop(diffusion: GaussianDiffusion, model_fn, noise: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *, clip_denoised: bool = True,
                  denoised_fn=None, w: Optional[float] = None, uncond_fn=None) -> torch.Tensor:
    """Ancestral (DDPM) chain from x_T = ``noise``; step noise from ``generator``."""
    x = noise
    for t in range(diffusion.num_timesteps - 1, -1, -1):
        x = diffusion.p_sample(model_fn, x, _full_t(t, x.shape[0], x.device), generator,
                               clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                               w=w, uncond_fn=uncond_fn)["sample"]
    return x


def ddim_sample_loop(diffusion: GaussianDiffusion, model_fn, noise: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *, clip_denoised: bool = True,
                     denoised_fn=None, eta: float = 0.0, w: Optional[float] = None,
                     uncond_fn=None) -> torch.Tensor:
    """DDIM chain from x_T = ``noise`` over every step of the (respaced) process."""
    x = noise
    for t in range(diffusion.num_timesteps - 1, -1, -1):
        x = diffusion.ddim_sample(model_fn, x, _full_t(t, x.shape[0], x.device), generator,
                                  clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                  eta=eta, w=w, uncond_fn=uncond_fn)["sample"]
    return x


def ddim_reverse_loop(diffusion: GaussianDiffusion, model_fn, x0: torch.Tensor, *,
                      num_steps: Optional[int] = None, clip_denoised: bool = True,
                      w: Optional[float] = None, uncond_fn=None) -> torch.Tensor:
    """Deterministic DDIM inversion x_0 -> x_{T-1} (abduction by ODE).

    The default inverts T-1 steps, yielding x at the level the generation
    chain's first step treats its input as (see the JAX docstring at
    ``causaldiffae_tpu/diffusion/sampling.py:103-139``).
    """
    n = num_steps if num_steps is not None else diffusion.num_timesteps - 1
    x = x0
    for t in range(n):
        x = diffusion.ddim_reverse_sample(model_fn, x, _full_t(t, x.shape[0], x.device),
                                          clip_denoised=clip_denoised, w=w,
                                          uncond_fn=uncond_fn)["sample"]
    return x


def dpm_solver_pp_nodes(diffusion: GaussianDiffusion, order: int = 2,
                        num_steps: Optional[int] = None):
    """Host-side DPM-Solver++ node grid and per-step coefficients.

    Computed in float64 off the (respaced) schedule and rounded to float32,
    exactly as ``causaldiffae_tpu/diffusion/sampling.py:206-234``. Returns
    ``(desc, sratio, a_next, phi, c2)``: the descending node timesteps and,
    per step, sigma_{t_i}/sigma_{t_{i-1}}, alpha_{t_i}, e^{-h_i} - 1 and the
    2M extrapolation weight (0 = first order).
    """
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    N_proc = diffusion.num_timesteps
    acp = np.asarray(diffusion.schedule.alphas_cumprod, dtype=np.float64)
    if num_steps is None or num_steps >= N_proc:
        desc = np.arange(N_proc - 1, -1, -1)
    else:
        lam_all = 0.5 * np.log(acp / (1.0 - acp))  # decreasing in t
        targets = np.linspace(lam_all[N_proc - 1], lam_all[0], num_steps)
        nodes = {int(np.argmin(np.abs(lam_all - tg))) for tg in targets}
        nodes.update((N_proc - 1, 0))  # endpoints exact
        desc = np.asarray(sorted(nodes, reverse=True))
    N = len(desc)
    alpha = np.sqrt(acp[desc])
    sigma = np.sqrt(1.0 - acp[desc])
    lam = np.log(alpha / sigma)
    a_next = np.append(alpha[1:], 1.0)          # terminal node: clean data
    sratio = np.append(sigma[1:], 0.0) / sigma  # sigma_{t_i}/sigma_{t_{i-1}}
    h = np.append(lam[1:] - lam[:-1], np.inf)   # terminal h -> inf
    phi = np.expm1(-h)                          # e^{-h} - 1; terminal -> -1
    c2 = np.zeros(N)
    if order >= 2 and N >= 3:
        c2[1:N - 1] = h[1:N - 1] / (2.0 * h[:N - 2])
    f32 = lambda a: a.astype(np.float32)
    return desc.astype(np.int64), f32(sratio), f32(a_next), f32(phi), f32(c2)


def dpm_solver_pp_loop(diffusion: GaussianDiffusion, model_fn, noise: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       clip_denoised: bool = True, denoised_fn=None,
                       w: Optional[float] = None, uncond_fn=None, order: int = 2,
                       num_steps: Optional[int] = None) -> torch.Tensor:
    """DPM-Solver++(2M) chain (deterministic; ``generator`` is ignored).

    Data-prediction multistep solver of Lu et al. 2022 (arXiv:2211.01095) on
    a lambda-uniform node grid; see the JAX docstring at
    ``causaldiffae_tpu/diffusion/sampling.py:155-200``. At ``order=1`` every
    step equals a DDIM eta=0 step.
    """
    del generator
    desc, sratio, a_next, phi, c2 = dpm_solver_pp_nodes(diffusion, order, num_steps)
    x = noise
    x0_prev = torch.zeros_like(noise)
    for i in range(len(desc)):
        t = _full_t(int(desc[i]), x.shape[0], x.device)
        out = diffusion.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                        denoised_fn=denoised_fn, w=w, uncond_fn=uncond_fn)
        x0 = out["pred_xstart"]
        d = x0 + float(c2[i]) * (x0 - x0_prev)
        x = float(sratio[i]) * x - float(a_next[i]) * float(phi[i]) * d
        x0_prev = x0
    return x
