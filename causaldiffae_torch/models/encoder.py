"""Causal semantic encoder and the anti-causal probe.

Port of ``causaldiffae_tpu/models/encoder.py:42-104``: a Conv(k3, s2, p1) ->
BatchNorm -> LeakyReLU stack, flattened, and two heads,
``mu = fc_mu(h)`` and ``var = softplus(fc_var(h)) + 1e-8``, or for the
probe one scalar head ``fc``. The convs run in
the compute dtype, BatchNorm and the heads in fp32. The flatten is C-major,
as torch's; weights carried from flax already hold that permutation
(``utils/weights.py``). Attribute names follow the reference keys
(``encoder.{i}.{0,1}``, ``fc_mu``, ``fc_var``, ``fc``).

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

from ..parallel.collectives import sum_across_ranks
from ..parallel.grid import dp_group, dp_size
from .layers import conv

BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, over_ranks: bool) -> torch.Tensor:
    """Train-mode BatchNorm with flax 0.12.3's ``_compute_stats`` semantics.

    The statistics are taken in fp32 over (N, H, W): mean and E[x^2] from
    the sums and the count, the variance ``E[x^2] - E[x]^2`` clipped at 0;
    the same mean and variance normalise the batch,
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. With ``over_ranks``
    under data parallelism the sums and the count are the global batch's
    (``parallel.sum_across_ranks`` over the DP group, whose gradient flows
    back to every rank; the ranks' shares are equal), as the JAX step takes
    them over its
    global array; ``nn.SyncBatchNorm``
    would not do: it updates the running variance with the unbiased
    estimate. The running buffers are updated IN PLACE, under ``no_grad``,
    with the biased batch variance: ``running = 0.9 * running + 0.1 * batch``,
    the same on every rank. Returns fp32.
    """
    x32 = x.float()
    n = x32.numel() // x32.shape[1]
    sums = torch.stack([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))])
    if over_ranks:
        sums, n = sum_across_ranks(sums, dp_group()), n * dp_size()
    mean = sums[0] / n
    var = (sums[1] / n - mean * mean).clamp(min=0.0)
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


class ConvTrunk(nn.Module):
    """The Conv-BN-LeakyReLU stride-2 stack under ``encoder.{i}.{0,1}``
    (``causaldiffae_tpu/models/encoder.py:42-57``); :meth:`trunk` returns the
    last stage's activations, NCHW, fp32. ``stats_over_ranks``: whether its
    train-mode statistics are the global batch's under data parallelism
    (the UNet's encoder, which the DDP train step runs), or each rank's own
    (the probe, which one rank trains alone)."""

    stats_over_ranks = False

    def __init__(self, in_channels: int, image_size: int, num_vars: int,
                 hidden_dims: Optional[Tuple[int, ...]], dtype: torch.dtype):
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
        self.flat_dim = ch * spatial * spatial

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW. In train mode BatchNorm uses the batch's statistics and
        updates its running buffers in place."""
        h = x
        for block in self.encoder:
            bn = block[1]
            h = conv(block[0], h, self.dtype)
            if self.training:
                h = batch_norm_train(h, bn, self.stats_over_ranks)
            else:
                h = F.batch_norm(h.float(), bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, training=False, eps=bn.eps)
            h = F.leaky_relu(h, 0.01)
        return h


class GaussianConvEncoder(ConvTrunk):
    """Encoder q(u | x0) returning (mu, var)."""

    stats_over_ranks = True

    def __init__(self, in_channels: int, image_size: int, latent_dim: int, num_vars: int = 4,
                 hidden_dims: Optional[Tuple[int, ...]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, image_size, num_vars, hidden_dims, dtype)
        self.fc_mu = nn.Linear(self.flat_dim, latent_dim)
        self.fc_var = nn.Linear(self.flat_dim, latent_dim)

    def encode(self, x: torch.Tensor):
        """x: NCHW -> (mu, var), both fp32."""
        h = self.trunk(x).flatten(1)
        mu = self.fc_mu(h)
        var = F.softplus(self.fc_var(h)) + 1e-8
        return mu, var

    forward = encode


class GaussianConvEncoderClf(ConvTrunk):
    """Anti-causal probe: the trunk and a scalar regression head ``fc``
    (``causaldiffae_tpu/models/encoder.py:85-104``), fp32, under the
    reference's keys, so a reference ``classifier_<factor>_best.pth`` loads
    once its dead ``fc_mu``/``fc_var`` heads are dropped. Images are NHWC,
    as the JAX module takes them."""

    def __init__(self, in_channels: int, image_size: int, num_vars: int = 4,
                 hidden_dims: Optional[Tuple[int, ...]] = None):
        super().__init__(in_channels, image_size, num_vars, hidden_dims, torch.float32)
        self.fc = nn.Linear(self.flat_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> [B, 1]; ``fc`` reads the C-major flatten."""
        return self.fc(self.trunk(x.permute(0, 3, 1, 2)).flatten(1))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk's activations flattened in the JAX module's (H, W, C)
        order, so that features compare element by element with
        ``GaussianConvEncoderClf.features`` there (FID's feature space when
        no Inception weights are given)."""
        return self.trunk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).flatten(1)
