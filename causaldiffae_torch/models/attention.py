"""Spatial self-attention block for the UNet.

Port of ``causaldiffae_tpu/models/attention.py:36-105``. The head layout is
the reference's: the QKV projection's output channels are grouped
head-major with [q, k, v] within each head.

Routing as in the JAX package: with ``use_kernels`` and bf16 compute the
attention core goes to the fused entry points of ``ops/attention.py``
(``fused_qkv_attention_t`` when head_dim == 32, else
``fused_qkv_attention``; both launch the one CUDA kernel); fp32 goes to
:func:`qkv_attention`, the JAX package's own einsum path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import fused_qkv_attention, fused_qkv_attention_t
from .layers import GroupNorm32


def einsum_scale(d: int, dtype: torch.dtype) -> float:
    """``1 / dtype(d^1/4)`` in ``dtype``, the einsum path's scale, as a float."""
    root = torch.sqrt(torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                              device="cpu"))).to(dtype)  # under any default device
    return float(1.0 / root)


def qkv_attention(qkv: torch.Tensor, num_heads: int,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Attention over tokens given fused head-major QKV (the einsum path).

    qkv: [B, T, 3C] -> [B, T, C], the math of the JAX ``qkv_attention``:
    q and k scaled by ``1 / dtype(d^1/4)`` in the input dtype, the scores
    rounded to the input dtype, softmax in fp32 and cast back, and the
    weighted sum of v rounded to the input dtype. (In bf16 at d = 32 this
    scale rounds to 0.421875 where the Pallas kernels' ``dtype(d^-1/4)``
    gives 0.419921875; each path keeps its own.) The scale is a float
    (``einsum_scale``, or ``scale`` where the caller computed it), a value
    of the dtype, so multiplying by it rounds as multiplying by the 0-d
    tensor does.
    """
    B, T, threeC = qkv.shape
    C = threeC // 3
    d = C // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(B, T, num_heads, 3 * d).split(d, dim=-1)
    if scale is None:
        scale = einsum_scale(d, dt)
    weight = torch.einsum("bthd,bshd->bhts", (q * scale).float(), (k * scale).float()).to(dt)
    weight = torch.softmax(weight.float(), dim=-1).to(dt)
    out = torch.einsum("bhts,bshd->bthd", weight.float(), v.float()).to(dt)
    return out.reshape(B, T, C)


class AttentionBlock(nn.Module):
    """Pre-norm residual attention over flattened spatial positions.

    GN -> 1x1 QKV -> attention -> zero-init 1x1 proj -> residual. Runs on
    NCHW activations: the QKV projection reads the [B, C, T] activations
    through a transposed view and writes [B, T, 3C] contiguously, which the
    kernel reads in place.
    """

    def __init__(self, channels: int, num_heads: int = 1, use_kernels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)
        # a float computed here, so a traced forward holds no tensor constant
        self.scale = einsum_scale(channels // num_heads, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        dt = self.dtype
        tokens = x.reshape(B, C, -1)                        # [B, C, T]
        normed = self.norm(tokens).transpose(1, 2)          # [B, T, C] view
        qkv = F.linear(normed.to(dt), self.qkv.weight[:, :, 0].to(dt), self.qkv.bias.to(dt))
        if self.use_kernels and qkv.dtype == torch.bfloat16:
            if C // self.num_heads == 32:
                h = fused_qkv_attention_t(qkv, self.num_heads)
            else:
                h = fused_qkv_attention(qkv, self.num_heads)
        else:
            h = qkv_attention(qkv, self.num_heads, self.scale)
        h = F.linear(h, self.proj_out.weight[:, :, 0].to(dt), self.proj_out.bias.to(dt))
        return (tokens + h.transpose(1, 2)).reshape(x.shape)
