"""Fused QKV self-attention forward: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/attention_fwd.cu``) replaces the JAX package's two
forward Pallas kernels, K1 ``_attn_kernel`` and K3 ``_attn_kernel_t``
(``causaldiffae_tpu/ops/attention_pallas.py:116-149,280-305``), which compute
one function in two orientations. Both public entry names are kept so the
routing in ``models/attention.py`` stays testable; both launch the same
kernel. The TPU-only choices (query chunking, deferred normalisation, the
full-lane orientation) are not part of the math and are not carried over.

``qkv`` is ``[B, T, 3C]`` with the head-major ``[q k v]`` interleave and the
output is ``[B, T, C]``, both in the input dtype. On a CPU tensor the wrapper
runs :func:`attention_plain`; on a CUDA tensor it launches the kernel or
raises. ``attention_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["attention_plain", "attention_fwd", "fused_qkv_attention",
           "fused_qkv_attention_t", "rounding_scale", "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (32, 64, 128)


def kernel_scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """d^-1/4 rounded to ``dtype`` once, as ``attention_pallas.py:129`` does."""
    return torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dtype)


@functools.lru_cache(maxsize=16)
def _bf16_scale(d: int) -> float:
    return float(kernel_scale(d, torch.bfloat16))


def attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function.

    q and k are scaled by d^-1/4 in the input dtype; the scores are exact
    products of those values summed in fp32; softmax in fp32; the
    probabilities are rounded to the input dtype and multiplied with v in
    fp32; the result is rounded to the input dtype.
    """
    B, T, threeC = qkv.shape
    C = threeC // 3
    d = C // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(B, T, num_heads, 3 * d).split(d, dim=-1)
    scale = kernel_scale(d, dt)
    s = torch.einsum("bthd,bshd->bhts", (q * scale).float(), (k * scale).float())
    p = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhts,bshd->bthd", p.float(), v.float())
    return out.to(dt).reshape(B, T, C)


def rounding_scale(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``sum_j p_j |v_j|`` for each output, in fp32: the scale of its rounding.

    Rounding p to bf16 errs by up to 2^-8 of each term ``p_j v_j`` and
    rounding the output by up to 2^-8 of the output, so two versions that
    round at different points (the kernel rounds the unnormalised p, the
    plain version the normalised p) may differ by 2^-6 of this sum: two bf16
    ulps of the terms' magnitude, whatever cancellation does to the output.
    """
    B, T, threeC = qkv.shape
    d = threeC // (3 * num_heads)
    parts = qkv.reshape(B, T, num_heads, 3, d).clone()
    parts[..., 2, :] = parts[..., 2, :].abs()
    return attention_plain(parts.reshape(B, T, threeC), num_heads).float()


def _library() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    fn = lib.cdae_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(qkv: torch.Tensor, num_heads: int) -> int:
    """Raise on anything the kernel does not take; return the head width."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, T, 3C] with C divisible by {num_heads} heads, "
                         f"got {tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, got {qkv.dtype}")
    B, T, threeC = qkv.shape
    d = threeC // (3 * num_heads)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head width {d} not in the kernel's {KERNEL_HEAD_DIMS}")
    if B < 1 or T < 1 or B > 65535 or num_heads > 65535:
        raise ValueError(f"unsupported B={B}, T={T}, heads={num_heads}")
    if qkv.stride(2) != 1 or qkv.stride(0) % 8 or qkv.stride(1) % 8:
        raise ValueError(f"qkv needs a contiguous channel axis and row strides that are "
                         f"multiples of 8 elements, got strides {qkv.stride()}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    return d


def attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel's wrapper: plain version on the CPU, the CUDA kernel on the card."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    d = _check(qkv, num_heads)
    B, T, threeC = qkv.shape
    out = torch.empty((B, T, threeC // 3), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = _library().cdae_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, d,
        qkv.stride(0), qkv.stride(1), out.stride(0), out.stride(1),
        _bf16_scale(d), stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {rc}")
    attention_fwd.launches += 1
    return out


attention_fwd.launches = 0


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Counterpart of the JAX ``fused_qkv_attention`` (K1's entry)."""
    return attention_fwd(qkv, num_heads)


def fused_qkv_attention_t(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Counterpart of the JAX ``fused_qkv_attention_t`` (K3's entry): same kernel."""
    return attention_fwd(qkv, num_heads)
