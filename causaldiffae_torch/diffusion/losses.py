"""Likelihood and KL helpers for the variational objective.

Port of ``causaldiffae_tpu/diffusion/losses.py:24-84``: the Gaussian KL in
(mean, log-variance) form, the elementwise KL in (mean, variance) form
summed over the last axis, and the discretized Gaussian decoder likelihood.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "normal_kl",
    "kl_normal",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "mean_flat",
]


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=like.dtype,
                                                                  device=like.device)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL between two diagonal Gaussians in (mean, log-variance) form; broadcasts."""
    like = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (_t(a, like) for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def kl_normal(qm, qv, pm, pv) -> torch.Tensor:
    """KL(q || p) between diagonal Gaussians in (mean, VARIANCE) form, summed
    over the last axis. The representation objective feeds the encoder's
    softplus'd output here as the variance, as the JAX package does."""
    element_wise = 0.5 * (torch.log(pv) - torch.log(qv) + qv / pv + (qm - pm) ** 2 / pv - 1.0)
    return element_wise.sum(-1)


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of images discretized to 256 bins in [-1, 1] under a Gaussian."""
    if not x.shape == means.shape == log_scales.shape:
        raise ValueError(f"shapes differ: {x.shape}, {means.shape}, {log_scales.shape}")
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))
