"""NN primitives for the UNet denoiser (NCHW inside).

Port of ``causaldiffae_tpu/models/layers.py:44-235``. Parameters are float32
and are cast to the compute dtype at each call, as flax does with
``dtype=bf16``. Conv and Linear keep torch's default init, which is the
JAX package's ``torch_kernel_init``/``torch_bias_init``; the ResBlock's last
conv is zero-initialised. Attribute names follow the reference torch
``state_dict`` keys (``in_layers.0``, ``emb_layers.1``, ``out_layers.3``, ...).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm_act import group_norm_act
from ..parallel.collectives import copy_to_group, reduce_from_group


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embeddings, float32, cos then sin (reference `nn.py:551-569`)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (input, weight and bias cast)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (input, weight and bias cast)."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                    layer.stride, layer.padding)


def conv3x3(ch_in: int, ch_out: int, stride: int = 1, zero_init: bool = False) -> nn.Conv2d:
    layer = nn.Conv2d(ch_in, ch_out, 3, stride=stride, padding=1)
    if zero_init:
        nn.init.zeros_(layer.weight)
        nn.init.zeros_(layer.bias)
    return layer


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) with float32 single-pass statistics.

    ``causaldiffae_tpu/models/layers.py:138-154``: mean and E[x^2] in fp32,
    var = E[x^2] - E[x]^2, eps 1e-5, affine in fp32, then a cast back to the
    input dtype BEFORE the optional scale-shift ``y * (1 + scale) + shift``
    and SiLU, which run in the input dtype.

    The whole chain is one call of ``ops.norm_act.group_norm_act``: with
    ``use_kernels`` (set by the model, as on its attention blocks) the
    hand-written kernel pair (``csrc/norm_act.cu``) on a card, in any dtype,
    and one ``causaldiffae::norm_act_fwd`` node in a traced forward; the
    eager chain on the CPU, and everywhere without ``use_kernels``.
    """

    use_kernels = True

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(num_groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor, scale_shift=None, silu_after: bool = False):
        scale, shift = (None, None) if scale_shift is None else scale_shift
        return group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps, scale, shift,
                              silu_after, self.use_kernels)


class Upsample(nn.Module):
    """Nearest x2 upsample + 3x3 conv (reference `unet.py:51-79`)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return conv(self.conv, x, self.dtype)


class Downsample(nn.Module):
    """Stride-2 3x3 conv (reference `unet.py:82-105`)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.op = conv3x3(channels, channels, stride=2)

    def forward(self, x):
        return conv(self.op, x, self.dtype)


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A ResBlock's place in its TP group: ``rank`` of ``size`` ranks, which
    holds output channels ``channels`` of the block's conv pair."""
    group: Any
    rank: int
    size: int
    channels: slice


class ResBlock(nn.Module):
    """Residual block with (scale-shift) GroupNorm timestep conditioning.

    ``causaldiffae_tpu/models/layers.py:191-235``. Dropout (``out_layers.2``,
    rate ``dropout``) acts in train mode only, after the second GroupNorm +
    SiLU and before the zero-initialised conv, as flax's ``nn.Dropout``:
    kept entries are divided by the keep probability in h's dtype (bf16 in
    the bf16 torso), the others zeroed. Its mask does not come from torch's
    global RNG: ``forward`` takes ``drop``, a callable that returns the keep
    mask (0/1) for a shape, always the block's full output shape. The UNet
    hands every ResBlock the same one, so it is called once per block in the
    order the blocks run; the train step draws from its (seed, step)
    generator through it, and a test replays flax's masks through it.
    :meth:`keep_mask` draws it and :meth:`block` is the rest, so that remat
    (``CausalUNet._apply_seq``) draws outside the recomputed region.

    Tensor parallelism (``parallel/partition.py`` sets ``tp``): Megatron's
    sharding of the conv pair over the TP group. ``in_layers.2`` holds this
    rank's output channels (column parallel), ``out_layers.0`` their
    GroupNorm (whole groups, ``32 / size`` of them), ``out_layers.3`` the
    same channels as its input (row parallel, its bias whole). The replicated
    h after ``in_layers.0`` and the replicated ``emb_layers`` output enter
    the shard through f (their gradients summed over the group), the row
    conv's partial outputs leave it through g (summed, in the compute dtype),
    and its bias is added once, after g. The scale and shift are this rank's
    channels of each half of the embedding projection, and the dropout mask
    is drawn at full width and cut, so the draws stay those of one process.
    """

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 use_scale_shift_norm: bool = False, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        out_ch = out_channels or channels
        self.channels = channels
        self.out_channels = out_ch
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dtype = dtype
        self.tp: Optional[TensorShard] = None
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), conv3x3(channels, out_ch))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
            conv3x3(out_ch, out_ch, zero_init=True))
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = nn.Conv2d(channels, out_ch, 1)

    def keep_mask(self, x: torch.Tensor, drop: Optional[Callable[[torch.Size], torch.Tensor]]
                  ) -> Optional[torch.Tensor]:
        """The dropout keep mask (bool) of the block's hidden h for the input
        (or hidden) ``x``: ``drop`` called with the block's full output shape,
        then cut to this rank's channels. None where dropout does not act."""
        rate = self.out_layers[2].p
        if not (self.training and rate > 0):
            return None
        if drop is None:
            raise ValueError("a ResBlock with dropout in train mode needs its mask source")
        shape = torch.Size((x.shape[0], self.out_channels, *x.shape[2:]))
        keep = drop(shape).to(device=x.device, dtype=torch.bool)
        return keep if self.tp is None else keep[:, self.tp.channels]

    def apply_dropout(self, h: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return h
        keep_prob = torch.tensor(1.0 - self.out_layers[2].p, dtype=h.dtype)
        return torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))

    def dropout(self, h: torch.Tensor, drop: Optional[Callable[[torch.Size], torch.Tensor]]):
        """Dropout of the hidden ``h`` with a mask from ``drop``."""
        return self.apply_dropout(h, self.keep_mask(h, drop))

    def scale_shift(self, emb_out: torch.Tensor):
        """(scale, shift) of this rank's channels: each half of the
        projection ``[scale | shift]``, cut to them."""
        scale, shift = torch.chunk(emb_out, 2, dim=-1)
        if self.tp is None:
            return scale, shift
        return scale[:, self.tp.channels], shift[:, self.tp.channels]

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                drop: Optional[Callable[[torch.Size], torch.Tensor]] = None) -> torch.Tensor:
        return self.block(x, emb, self.keep_mask(x, drop))

    def block(self, x: torch.Tensor, emb: torch.Tensor,
              keep: Optional[torch.Tensor]) -> torch.Tensor:
        """The block on ``x`` with the dropout keep mask ``keep`` (or None)."""
        dt = self.dtype
        tp = self.tp
        # the skip first: remat's recompute, which stops at the last tensor
        # the backward saved, then ends before g (no repeated all-reduce)
        if isinstance(self.skip_connection, nn.Conv2d):
            skip = conv(self.skip_connection, x, dt)
        else:
            skip = x
        h = self.in_layers[0](x, silu_after=True)
        emb_out = linear(self.emb_layers[1], silu(emb), dt)
        if tp is not None:
            h, emb_out = copy_to_group(h, tp.group), copy_to_group(emb_out, tp.group)
        h = conv(self.in_layers[2], h, dt)
        if self.use_scale_shift_norm:
            h = self.out_layers[0](h, scale_shift=self.scale_shift(emb_out), silu_after=True)
        else:
            part = emb_out if tp is None else emb_out[:, tp.channels]
            h = h + part[:, :, None, None]
            h = self.out_layers[0](h, silu_after=True)
        h = self.apply_dropout(h, keep)
        out = self.out_layers[3]
        if tp is None:
            h = conv(out, h, dt)
        else:
            h = F.conv2d(h.to(dt), out.weight.to(dt), None, out.stride, out.padding)
            h = reduce_from_group(h, tp.group) + out.bias.to(dt)[:, None, None]
        return skip + h
