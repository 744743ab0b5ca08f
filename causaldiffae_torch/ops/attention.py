"""Fused QKV self-attention: the CUDA kernels' wrappers, plain versions and gradient.

The forward kernel (``csrc/attention_fwd.cu``) replaces the JAX package's two
forward Pallas kernels, K1 ``_attn_kernel`` and K3 ``_attn_kernel_t``
(``causaldiffae_tpu/ops/attention_pallas.py:116-149,280-305``); the backward
kernel (``csrc/attention_bwd.cu``) replaces their custom VJPs, K2
``_attn_bwd_kernel`` and K4 ``_attn_bwd_kernel_t`` (``:184-248,308-381``).
Each pair computes one function in two orientations, so one kernel serves
both. Both public entry names are kept so the routing in
``models/attention.py`` stays testable; both go through one
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward launches the backward kernel. Where K2 keeps only ``qkv``
(``attention_pallas.py:409``) and recomputes the row statistics, the
Function also saves the forward's output and row logsumexp (lse): the
backward then takes p = exp(s - lse) and D = rowsum(g o) without a pass of
its own over the keys. The function is the same. The TPU-only choices
(query chunking, deferred normalisation, the full-lane orientation) are not
part of the math and are not carried over.

``qkv`` is ``[B, T, 3C]`` with the head-major ``[q k v]`` interleave and the
output is ``[B, T, C]``, both in the input dtype. On a CPU tensor each wrapper
runs its plain version; on a CUDA tensor it launches its kernel or raises.
``attention_fwd.launches`` and ``attention_bwd.launches`` count launches,
``attention_fwd.lse_launches`` those forward launches that wrote lse;
``utils/tracing.py``'s snapshot carries the three under ``cdae.`` names.

The forward without a gradient is also the dispatcher op
``torch.ops.causaldiffae.attention_fwd(qkv, num_heads)`` (registered when this
module is imported), so that ``torch.export`` and AOTInductor keep it as one
node of a serving artifact's graph: a ctypes call is opaque to them. Its
implementation is :func:`attention_fwd`, so a run of an exported program
counts its launches as an eager run does. :func:`fused_qkv_attention` sends
every call that needs no gradient (serving, evaluation, an artifact) through
the op, and a call that does through ``FusedAttention``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import tracing
from . import _build

__all__ = ["attention_plain", "attention_fwd", "attention_fwd_op", "prepare_forward",
           "attention_bwd_plain",
           "attention_bwd_exact",
           "attention_bwd",
           "fused_qkv_attention", "fused_qkv_attention_t", "rounding_scale",
           "bwd_rounding_scale", "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (32, 64, 128)


def kernel_scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """d^-1/4 rounded to ``dtype`` once, as ``attention_pallas.py:129`` does."""
    return torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dtype)


@functools.lru_cache(maxsize=16)
def _bf16_scale(d: int) -> float:
    return float(kernel_scale(d, torch.bfloat16))


def attention_plain(qkv: torch.Tensor, num_heads: int, with_lse: bool = False):
    """Plain PyTorch version of the kernel's function.

    q and k are scaled by d^-1/4 in the input dtype; the scores are exact
    products of those values summed in fp32; softmax in fp32; the
    probabilities are rounded to the input dtype and multiplied with v in
    fp32; the result is rounded to the input dtype. With ``with_lse`` it
    also returns the fp32 logsumexp of each row of scores, ``[B, H, T]``.
    """
    B, T, threeC = qkv.shape
    C = threeC // 3
    d = C // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(B, T, num_heads, 3 * d).split(d, dim=-1)
    scale = kernel_scale(d, dt)
    s = torch.einsum("bthd,bshd->bhts", (q * scale).float(), (k * scale).float())
    p = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhts,bshd->bthd", p.float(), v.float()).to(dt).reshape(B, T, C)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


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


def _bwd_terms(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, *,
               magnitude: bool = False, exact: bool = False):
    """K2's gradient step by step in fp32 einsums. With ``magnitude``, the
    same products on the absolute values of their terms; with ``exact``, in
    fp64 with p and ds left unrounded."""
    B, T, threeC = qkv.shape
    C = threeC // 3
    d = C // num_heads
    dt = qkv.dtype
    acc = torch.float64 if exact else torch.float32
    rnd = (lambda a: a) if exact else (lambda a: a.to(dt).to(acc))
    q, k, v = qkv.reshape(B, T, num_heads, 3 * d).split(d, dim=-1)
    scale = kernel_scale(d, dt)
    q_s, k_s = (q * scale).to(acc), (k * scale).to(acc)   # rounded to dt first
    v, g = v.to(acc), g.reshape(B, T, num_heads, d).to(acc)
    fix = torch.abs if magnitude else (lambda a: a)
    p = torch.softmax(torch.einsum("bthd,bshd->bhts", q_s, k_s), dim=-1)
    dv = torch.einsum("bhts,bthd->bshd", rnd(p), fix(g))
    dp = torch.einsum("bthd,bshd->bhts", fix(g), fix(v))
    dsum = (fix(dp) * p).sum(-1, keepdim=True)
    ds = rnd(p * (dp + dsum) if magnitude else p * (dp - dsum))
    dq = torch.einsum("bhts,bshd->bthd", ds, fix(k_s)) * scale.to(acc)
    dk = torch.einsum("bhts,bthd->bshd", ds, fix(q_s)) * scale.to(acc)
    return torch.cat([dq, dk, dv], dim=-1).reshape(B, T, threeC)


def attention_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: dqkv ``[B, T, 3C]`` from
    qkv and the output's gradient ``g`` ``[B, T, C]``.

    K2's math and rounding points (``attention_pallas.py:206-248``): q and k
    scaled by d^-1/4 in the input dtype; s and the softmax p in fp32; dv =
    dtype(p)^T g; dp = g v^T; ds = p (dp - rowsum(dp p)) in fp32 and rounded
    to the input dtype; dq = ds k_s d^-1/4 and dk = ds^T q_s d^-1/4, each
    product summed in fp32; the three gradients rounded to the input dtype
    once, in the ``[q k v]`` interleave.
    """
    return _bwd_terms(qkv, g, num_heads).to(qkv.dtype)


def attention_bwd_exact(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The backward's function in fp64, fp64 ``[B, T, 3C]``: the gradient the
    rounded versions approximate, with no rounding after the scaling of q and k."""
    return _bwd_terms(qkv, g, num_heads, exact=True)


def bwd_rounding_scale(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The plain backward on the absolute values of its terms, fp32 ``[B, T, 3C]``.

    Each output of the backward is a sum of products of bf16-rounded terms
    (p or ds with g, k_s or q_s), and each version rounds those terms and the
    output once. Two versions whose fp32 inputs to a rounding differ in the
    last bits may land one bf16 ulp apart, at most 2^-7 of the value; so
    they may differ by 2^-7 of this sum through the terms and 2^-7 through
    the output: 2^-6 of it, whatever cancellation does to the output.
    """
    return _bwd_terms(qkv, g, num_heads, magnitude=True)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, ctypes.c_float, _P],
    "attention_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L,
                      ctypes.c_float, _P],
}


# the kernels of each library, in the order of their index in ``cdae_<name>_info``
KERNELS = {"attention_fwd": ("attention_fwd_kernel",),
           "attention_bwd": ("attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")}


def launch_info(name: str, kernel: str, d: int):
    """``(dynamic shared memory in bytes, blocks per SM)`` with which
    ``kernel`` of ``csrc/<name>.cu`` launches at head width ``d``: the size
    its host code sets, and the blocks of 128 threads that this and the
    kernel's registers let one SM of the current card hold."""
    fn = getattr(_build.load(name), f"cdae_{name}_info")
    fn.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    smem, blocks = _I(), _I()
    rc = fn(d, KERNELS[name].index(kernel), ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"cdae_{name}_info({d}, {kernel}) failed: CUDA error {rc}")
    return smem.value, blocks.value


def _kernel(name: str):
    """The C entry ``cdae_<name>`` of ``csrc/<name>.cu``, built and typed on first use."""
    fn = getattr(_build.load(name), f"cdae_{name}")
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


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


def _check_rows(name: str, t: torch.Tensor, shape) -> None:
    """A bf16 ``[B, T, n]`` tensor with a contiguous channel axis, 16-byte
    aligned, and row strides that are multiples of 8 elements."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16 {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned channel axis and row "
                         f"strides that are multiples of 8 elements, got strides {t.stride()}")


def _padded_rows(T: int) -> int:
    """Rows of the row statistics: T rounded up to the kernels' 64-row tile."""
    return -(-T // 64) * 64


def _check_grad(qkv, g, num_heads, out, lse) -> int:
    """``_check`` for qkv; g and the forward's output ``[B, T, C]`` as the
    kernel reads them; lse as the forward kernel wrote it."""
    d = _check(qkv, num_heads)
    B, T, threeC = qkv.shape
    for name, t in (("g", g), ("out", out), ("lse", lse)):
        if t is None:
            raise ValueError(f"the backward kernel needs {name}: pass the forward kernel's "
                             "output and lse")
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
    _check_rows("g", g, (B, T, threeC // 3))
    _check_rows("out", out, (B, T, threeC // 3))
    Tp = _padded_rows(T)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, num_heads, T)
            or lse.stride() != (num_heads * Tp, Tp, 1)):
        raise ValueError(f"lse must be the forward kernel's fp32 [B, H, T] view of "
                         f"[B, H, {Tp}], got {lse.dtype} {tuple(lse.shape)} strides "
                         f"{lse.stride()}")
    return d


def attention_fwd(qkv: torch.Tensor, num_heads: int, with_lse: bool = False):
    """The kernel's wrapper: plain version on the CPU, the CUDA kernel on the card.

    Returns the output ``[B, T, C]``, and with ``with_lse`` also the fp32
    logsumexp of each row of scores, ``[B, H, T]``: on the card a view of
    ``[B, H, Tp]`` (T rounded up to 64), the layout the backward kernel
    reads. Without it the kernel writes no row statistics.
    """
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads, with_lse)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    d = _check(qkv, num_heads)
    B, T, threeC = qkv.shape
    out = torch.empty((B, T, threeC // 3), dtype=qkv.dtype, device=qkv.device)
    lse = None
    if with_lse:
        lse = torch.empty((B, num_heads, _padded_rows(T)), dtype=torch.float32,
                          device=qkv.device)[..., :T]
    with torch.cuda.device(qkv.device):   # the C side binds the current device's context
        rc = _kernel("attention_fwd")(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, T, num_heads, d, qkv.stride(0), qkv.stride(1), out.stride(0), out.stride(1),
            _bf16_scale(d), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {rc}")
    attention_fwd.launches += 1
    if with_lse:
        attention_fwd.lse_launches += 1
        return out, lse
    return out


attention_fwd.launches = 0
attention_fwd.lse_launches = 0  # launches that wrote lse (the training path's)


@torch.library.custom_op("causaldiffae::attention_fwd", mutates_args=())
def attention_fwd_op(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward without lse as a dispatcher op: :func:`attention_fwd`."""
    return attention_fwd(qkv, num_heads)


@attention_fwd_op.register_fake
def _(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    # shapes only: what a traced graph needs to know of the output
    B, T, threeC = qkv.shape
    return qkv.new_empty((B, T, threeC // 3))


def attention_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                  out: torch.Tensor = None, lse: torch.Tensor = None) -> torch.Tensor:
    """The backward kernel's wrapper: plain version on the CPU, the CUDA kernel on the card.

    Returns dqkv ``[B, T, 3C]`` in qkv's dtype. ``out`` and ``lse`` are the
    forward kernel's output and row logsumexp (``attention_fwd(..,
    with_lse=True)``); the kernel needs both, the plain version neither. It
    writes D = rowsum(g o) to fp32 scratch ``[B, H, Tp]``, allocated here.
    """
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, g, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    d = _check_grad(qkv, g, num_heads, out, lse)
    B, T, threeC = qkv.shape
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    dsum = torch.empty((B, num_heads, _padded_rows(T)), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _kernel("attention_bwd")(
            qkv.data_ptr(), g.data_ptr(), out.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
            dsum.data_ptr(), B, T, num_heads, d, qkv.stride(0), qkv.stride(1), g.stride(0),
            g.stride(1), out.stride(0), out.stride(1), dqkv.stride(0), dqkv.stride(1),
            _bf16_scale(d), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd launch failed: CUDA error {rc}")
    attention_bwd.launches += 1
    return dqkv


attention_bwd.launches = 0
tracing.counters_from(lambda: {"cdae.attention_fwd.launches": attention_fwd.launches,
                               "cdae.attention_fwd.lse_launches": attention_fwd.lse_launches,
                               "cdae.attention_bwd.launches": attention_bwd.launches})


class FusedAttention(torch.autograd.Function):
    """softmax((q s)(k s)^T) v with s = d^-1/4: the forward kernel forward,
    the backward kernel backward. When qkv needs a gradient the forward also
    writes the row logsumexp and saves qkv, the output and lse; the backward
    takes the probabilities from lse and D = rowsum(g o) from the output, so
    it recomputes each score once."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.num_heads = num_heads
        if not ctx.needs_input_grad[0]:
            return attention_fwd(qkv, num_heads)
        out, lse = attention_fwd(qkv, num_heads, True)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        return attention_bwd(qkv, g.contiguous(), ctx.num_heads, out, lse), None


@tracing.traced("cdae.setup.prepare_forward")
def prepare_forward(device) -> None:
    """Make the no-grad forward ready before the first request: build the
    kernel on a card, and call the op once on a tiny CPU tensor, since the
    first call of a ``torch.library`` op in a process imports its machinery,
    which takes seconds. The norm kernels (``csrc/norm_act.cu``) are built
    here too, because the benchmark's serving generator readies a model by
    this call alone; the program's entry points call ``ops.prepare``."""
    if str(device).startswith("cuda"):
        _build.build("attention_fwd")
        _build.build("norm_act")
    torch.ops.causaldiffae.attention_fwd(torch.zeros(1, 1, 96, dtype=torch.bfloat16), 1)


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Counterpart of the JAX ``fused_qkv_attention`` (K1, and K2 as its VJP):
    ``FusedAttention`` where qkv needs a gradient, else the op."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedAttention.apply(qkv, num_heads)
    return torch.ops.causaldiffae.attention_fwd(qkv, num_heads)


def fused_qkv_attention_t(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Counterpart of the JAX ``fused_qkv_attention_t`` (K3, and K4 as its VJP): same kernels."""
    return fused_qkv_attention(qkv, num_heads)
