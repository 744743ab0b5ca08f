"""Sampling chains: one reverse step, run by a Python loop or by ``while_loop``.

Port of ``causaldiffae_tpu/diffusion/sampling.py:36-295``. The JAX package
runs each chain (and the VLB sweep) as one ``lax.scan``. Here each chain is
one step function over a carry (x, and x0_prev for DPM-Solver++) and the
chain's per-step inputs (the timestep, DDPM's step noise, DPM-Solver++'s
coefficients), all tensors on the chain's device, and two loops run it:

- the eager loop (the default): a Python loop of eager model calls that
  slices step i of the inputs, a view, so it does not wait on the device;
- the traceable form (``traceable=True``), for ``torch.export``: one
  ``torch._higher_order_ops.while_loop`` around one step, which export keeps
  as one loop around one UNet graph (a Python loop would be unrolled into
  one copy of the UNet per step). Its predicate reads a counter that lives
  on the CPU, so no step waits on the device to decide whether to go on; a
  second counter on the chain's device picks step i of the inputs with
  ``index_select``. Outside a trace, ``while_loop`` compiles its body with
  ``torch.compile``: this form is for export only.

The traceable form is a ``while_loop`` and not a ``scan`` (the JAX chains'
``lax.scan``, whose length is fixed) because in PyTorch 2.11 AOTInductor
cannot compile ``scan`` (its C++ wrapper fails an assertion in
``codegen_subgraph_prefix`` for every scan, even one that captures
nothing), and an exported ``scan`` run eagerly calls its body once more
than its length. Both forms run the same step function, so they
compute the same thing; the schedule lookups gather by the step's timestep
broadcast to ``[B]``, never by a 0-d loop counter. Each step of the eager
loop runs in the span ``cdae.chain.step`` (``utils/tracing.py``); the
traceable form holds none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import tracing
from .process import GaussianDiffusion

__all__ = [
    "p_sample_loop",
    "ddim_sample_loop",
    "ddim_reverse_loop",
    "dpm_solver_pp_loop",
    "calc_bpd_loop",
]


def _full_t(t: int, B: int, device) -> torch.Tensor:
    return torch.full((B,), t, dtype=torch.long, device=device)


def _run(diffusion: GaussianDiffusion, step, carry, xs, traceable: bool):
    """``carry = step(carry, xs_i)`` for each i along the first axis of every
    tensor in the tuple ``xs``: a Python loop, or with ``traceable`` one
    ``while_loop`` (see the module's docstring). The carry is a tuple of
    tensors."""
    n = xs[0].shape[0]
    if not traceable:
        for i in range(n):
            with tracing.span("cdae.chain.step"):
                carry = step(carry, tuple(x[i] for x in xs))
        return carry
    from torch._higher_order_ops import while_loop

    diffusion.arrays_on(xs[0].device)   # raises unless an exporter copied them first

    def body(i, j, *c):
        x_i = tuple(x.index_select(0, j).squeeze(0) for x in xs)
        return (i + 1, j + 1, *step(c, x_i))

    host = torch.zeros((), dtype=torch.long)                       # the predicate's
    dev = torch.zeros((1,), dtype=torch.long, device=xs[0].device)  # the inputs' index
    return tuple(while_loop(lambda i, j, *c: i < n, body, (host, dev, *carry))[2:])


def _descending(diffusion: GaussianDiffusion, device) -> torch.Tensor:
    return torch.arange(diffusion.num_timesteps - 1, -1, -1, dtype=torch.long, device=device)


def p_sample_loop(diffusion: GaussianDiffusion, model_fn, noise: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *, clip_denoised: bool = True,
                  denoised_fn=None, w: Optional[float] = None, uncond_fn=None,
                  step_noise: Optional[torch.Tensor] = None, traceable: bool = False) -> torch.Tensor:
    """Ancestral (DDPM) chain from x_T = ``noise``. ``step_noise`` ``[N, B,
    ...]`` holds each step's draw, in the order the steps run; without it
    each is drawn from ``generator`` as its step comes (the traceable form
    needs it given)."""
    def step(carry, xs):
        (x,), (t, eps) = carry, xs
        return (diffusion.p_sample(model_fn, x, t.expand(x.shape[0]), clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, w=w, uncond_fn=uncond_fn,
                                   noise=eps)["sample"],)

    ts = _descending(diffusion, noise.device)
    if step_noise is None and not traceable:   # draw each step's noise when its step comes
        x = noise
        for t in ts:
            x = step((x,), (t, torch.randn(x.shape, generator=generator, device=x.device,
                                           dtype=x.dtype)))[0]
        return x
    if step_noise is None:
        raise ValueError("the traceable DDPM chain takes its draws as step_noise")
    return _run(diffusion, step, (noise,), (ts, step_noise), traceable)[0]


def ddim_sample_loop(diffusion: GaussianDiffusion, model_fn, noise: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *, clip_denoised: bool = True,
                     denoised_fn=None, eta: float = 0.0, w: Optional[float] = None,
                     uncond_fn=None, traceable: bool = False) -> torch.Tensor:
    """DDIM chain from x_T = ``noise`` over every step of the (respaced) process."""
    def step(carry, xs):
        (x,), (t,) = carry, xs
        return (diffusion.ddim_sample(model_fn, x, t.expand(x.shape[0]), generator,
                                      clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                      eta=eta, w=w, uncond_fn=uncond_fn)["sample"],)

    return _run(diffusion, step, (noise,), (_descending(diffusion, noise.device),), traceable)[0]


def ddim_reverse_loop(diffusion: GaussianDiffusion, model_fn, x0: torch.Tensor, *,
                      num_steps: Optional[int] = None, clip_denoised: bool = True,
                      w: Optional[float] = None, uncond_fn=None,
                      traceable: bool = False) -> torch.Tensor:
    """Deterministic DDIM inversion x_0 -> x_{T-1} (abduction by ODE).

    The default inverts T-1 steps, yielding x at the level the generation
    chain's first step treats its input as (see the JAX docstring at
    ``causaldiffae_tpu/diffusion/sampling.py:103-139``).
    """
    def step(carry, xs):
        (x,), (t,) = carry, xs
        return (diffusion.ddim_reverse_sample(model_fn, x, t.expand(x.shape[0]),
                                              clip_denoised=clip_denoised, w=w,
                                              uncond_fn=uncond_fn)["sample"],)

    n = num_steps if num_steps is not None else diffusion.num_timesteps - 1
    ts = torch.arange(n, dtype=torch.long, device=x0.device)
    return _run(diffusion, step, (x0,), (ts,), traceable)[0]


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
                       num_steps: Optional[int] = None, traceable: bool = False) -> torch.Tensor:
    """DPM-Solver++(2M) chain (deterministic; ``generator`` is ignored).

    Data-prediction multistep solver of Lu et al. 2022 (arXiv:2211.01095) on
    a lambda-uniform node grid; see the JAX docstring at
    ``causaldiffae_tpu/diffusion/sampling.py:155-200``. At ``order=1`` every
    step equals a DDIM eta=0 step. The node timesteps and the per-node
    float32 coefficients are the steps' inputs, as tensors.
    """
    del generator

    def step(carry, xs):
        (x, x0_prev), (t, sratio, a_next, phi, c2) = carry, xs
        out = diffusion.p_mean_variance(model_fn, x, t.expand(x.shape[0]),
                                        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                        w=w, uncond_fn=uncond_fn)
        x0 = out["pred_xstart"]
        d = x0 + c2 * (x0 - x0_prev)
        return sratio * x - (a_next * phi) * d, x0

    xs = tuple(torch.from_numpy(a).to(noise.device)
               for a in dpm_solver_pp_nodes(diffusion, order, num_steps))
    return _run(diffusion, step, (noise, torch.zeros_like(noise)), xs, traceable)[0]


def calc_bpd_loop(diffusion: GaussianDiffusion, model_fn, x_start: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *, clip_denoised: bool = True,
                  noise: Optional[torch.Tensor] = None) -> dict:
    """The full per-timestep VLB sweep in bits/dim.

    For every t of the (non-respaced) process: ``x_t = q_sample(x_0, t,
    eps)``, the VLB term, and the x0 and eps MSEs per sample. ``noise``
    ``[T, B, ...]`` gives eps for each t (ascending); without it each eps is
    drawn from ``generator``. Returns ascending-t ``[N, T]`` arrays ``vb``,
    ``xstart_mse`` and ``mse``, ``prior_bpd`` ``[N]`` and ``total_bpd`` =
    ``vb.sum(1) + prior_bpd``, as ``causaldiffae_tpu/diffusion/sampling.py:253-295``.
    """
    B = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for i in range(diffusion.num_timesteps):
        t = _full_t(i, B, x_start.device)
        eps = noise[i] if noise is not None else torch.randn(
            x_start.shape, generator=generator, device=x_start.device, dtype=x_start.dtype)
        x_t = diffusion.q_sample(x_start, t, eps)
        out = diffusion.vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=clip_denoised)
        eps_pred = diffusion.predict_eps_from_xstart(x_t, t, out["pred_xstart"])
        vb.append(out["output"])
        xstart_mse.append(((out["pred_xstart"] - x_start) ** 2).reshape(B, -1).mean(-1))
        mse.append(((eps_pred - eps) ** 2).reshape(B, -1).mean(-1))
    vb = torch.stack(vb, dim=1)
    prior_bpd = diffusion.prior_bpd(x_start)
    return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
            "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}
