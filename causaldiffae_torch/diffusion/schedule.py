"""Beta schedules and precomputed diffusion coefficient arrays.

The port's own copy of ``causaldiffae_tpu/diffusion/schedule.py`` (numpy
only). Rebuild of the schedule math in the reference
(`improved_diffusion/gaussian_diffusion.py:21-65` for the named schedules and
`:137-179` for the derived buffers). All coefficient arrays are computed once
on the host in float64 (the reference's "Use float64 for accuracy" at
`gaussian_diffusion.py:136`) and stored as float32 numpy arrays; the
process (``process.py``) moves each array to the device once and gathers
from it there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

__all__ = [
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "DiffusionSchedule",
    "make_schedule",
]


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedule (reference `gaussian_diffusion.py:21-45`).

    ``linear``: Ho et al.'s schedule, endpoints scaled by ``1000/T`` so the
    process limit is invariant to T. ``cosine``: Nichol & Dhariwal.
    """
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas.

    Mirrors reference `gaussian_diffusion.py:48-65`.
    """
    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    t1 = t / num_diffusion_timesteps
    t2 = (t + 1) / num_diffusion_timesteps
    ab = np.vectorize(alpha_bar)
    return np.minimum(1.0 - ab(t2) / ab(t1), max_beta)


class DiffusionSchedule(NamedTuple):
    """Every per-timestep coefficient the q/p math needs, as float32 arrays.

    One-to-one with the buffers precomputed by the reference constructor
    (`gaussian_diffusion.py:137-179`), plus the FIXED_LARGE variance pair that
    the reference rebuilds inside ``p_mean_variance`` on every call
    (`gaussian_diffusion.py:305-311`) - here precomputed once.
    """

    betas: np.ndarray
    log_betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    fixed_large_variance: np.ndarray
    fixed_large_log_variance: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(betas: np.ndarray) -> DiffusionSchedule:
    """Precompute all derived coefficient arrays from a 1-D betas array.

    Math follows reference `gaussian_diffusion.py:137-179` exactly; computed
    in float64, stored float32.
    """
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1, "betas must be 1-D"
    assert (betas > 0).all() and (betas <= 1).all()

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # Clipped because posterior variance is 0 at t=0.
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )

    # FIXED_LARGE: variance beta_t, except variance[0] = posterior_variance[1]
    # for a better decoder likelihood (reference gaussian_diffusion.py:305-311).
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        log_betas=f32(np.log(betas)),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        fixed_large_variance=f32(fixed_large_variance),
        fixed_large_log_variance=f32(np.log(fixed_large_variance)),
    )
