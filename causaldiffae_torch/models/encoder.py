"""Causal semantic encoder.

Port of ``causaldiffae_tpu/models/encoder.py:42-82``: a Conv(k3, s2, p1) ->
BatchNorm -> LeakyReLU stack, flattened, and two heads,
``mu = fc_mu(h)`` and ``var = softplus(fc_var(h)) + 1e-8``. The convs run in
the compute dtype, BatchNorm and the heads in fp32. The flatten is C-major,
as torch's; weights carried from flax already hold that permutation
(``utils/weights.py``). Attribute names follow the reference keys
(``encoder.{i}.{0,1}``, ``fc_mu``, ``fc_var``).

BatchNorm follows flax's semantics (the JAX package is the reference), not
torch's: in eval mode it normalises with the running statistics; in train
mode (:func:`batch_norm_train`) with the batch's, and it updates the running
variance with the BIASED batch variance, where ``F.batch_norm`` would use
the unbiased one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv

BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm with flax 0.12.3's ``_compute_stats`` semantics.

    The statistics are taken in fp32 over (N, H, W): mean and E[x^2], the
    variance ``E[x^2] - E[x]^2`` clipped at 0; the same mean and variance
    normalise the batch, ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.
    The running buffers are updated IN PLACE, under ``no_grad``, with the
    biased batch variance: ``running = 0.9 * running + 0.1 * batch``.
    Returns fp32.
    """
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x32 - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bn.bias[None, :, None, None]


def default_hidden_dims(num_vars: int) -> Tuple[int, ...]:
    """Reference `nn.py:39-43`."""
    if num_vars == 4:
        return (16, 32, 32, 64, 64, 128)
    if num_vars == 2:
        return (16, 32, 64, 128)
    raise ValueError(f"no default encoder hidden dims for num_vars={num_vars}")


class GaussianConvEncoder(nn.Module):
    """Encoder q(u | x0) returning (mu, var)."""

    def __init__(self, in_channels: int, image_size: int, latent_dim: int, num_vars: int = 4,
                 hidden_dims: Optional[Tuple[int, ...]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = hidden_dims or default_hidden_dims(num_vars)
        self.dtype = dtype
        layers = []
        ch, spatial = in_channels, image_size
        for h_dim in dims:
            layers.append(nn.Sequential(
                nn.Conv2d(ch, h_dim, 3, stride=2, padding=1),
                nn.BatchNorm2d(h_dim, eps=1e-5, momentum=0.1),
                nn.LeakyReLU(0.01),
            ))
            ch, spatial = h_dim, (spatial + 1) // 2
        self.encoder = nn.Sequential(*layers)
        self.fc_mu = nn.Linear(ch * spatial * spatial, latent_dim)
        self.fc_var = nn.Linear(ch * spatial * spatial, latent_dim)

    def encode(self, x: torch.Tensor):
        """x: NCHW -> (mu, var), both fp32. In train mode BatchNorm uses the
        batch's statistics and updates its running buffers in place."""
        h = x
        for block in self.encoder:
            bn = block[1]
            h = conv(block[0], h, self.dtype)
            if self.training:
                h = batch_norm_train(h, bn)
            else:
                h = F.batch_norm(h.float(), bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, training=False, eps=bn.eps)
            h = F.leaky_relu(h, 0.01)
        h = h.flatten(1)
        mu = self.fc_mu(h)
        var = F.softplus(self.fc_var(h)) + 1e-8
        return mu, var

    forward = encode
