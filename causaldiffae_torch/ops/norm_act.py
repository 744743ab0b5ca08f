"""GroupNorm + scale-shift + SiLU: the CUDA kernels' wrappers, plain versions and gradient.

``GroupNorm32`` (``models/layers.py``) computes, per batch element and group
of 32, fp32 statistics, the fp32 affine, a cast back to the input dtype,
then optionally ``y * (1 + scale) + shift`` and SiLU in the input dtype
(``causaldiffae_tpu/models/layers.py:138-154``). In eager PyTorch that is
15-18 launches forward and 25-30 backward per call. The forward kernel
(``csrc/norm_act.cu``, ``norm_act_fwd_kernel``) does the whole chain in one
pass at the eager chain's rounding points, and saves the group's mean and
rstd; the backward kernel recomputes from x and those, and returns dx,
d_scale and d_shift per (b, c), and d_weight and d_bias per channel (a
second, small launch sums those over b). Neither replaces a Pallas kernel:
XLA fused this chain on the TPU.

On a CPU tensor each wrapper runs its plain version: :func:`norm_act_plain`
is the eager chain itself, :func:`norm_act_bwd_plain` the backward's formula
in fp32 torch. On a CUDA tensor it launches its kernel or raises.
``norm_act_fwd.launches`` and ``norm_act_bwd.launches`` count launches;
``utils/tracing.py``'s snapshot carries them as ``cdae.norm_act_fwd.launches``
and ``cdae.norm_act_bwd.launches``.

The forward without a gradient is also the dispatcher op
``torch.ops.causaldiffae.norm_act_fwd`` (registered when this module is
imported), so that ``torch.export`` and AOTInductor keep the norm as one node
of a serving artifact. :func:`group_norm_act`, the module's entry, has one
rule: with ``use_kernels`` (the model's), a call on a card launches the
kernels, straight from eager code (the op costs ~13.5 us of host a call) and
through the op from a traced one, whatever the dtype; a CPU call runs the
eager chain, through the op where traced. Without ``use_kernels`` every call
runs the eager chain, so that a plain-route artifact loads with torch alone.
A traced call that needs a gradient raises: the backward kernel is reached
from eager autograd only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import tracing
from . import _build

__all__ = ["norm_act_plain", "norm_act_stats_plain", "norm_act_bwd_plain", "norm_act_fwd",
           "norm_act_bwd", "norm_act_fwd_op", "NormAct", "group_norm_act", "plan"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "cdae_norm_act_fwd": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _I, _I, _L, _I, _I, _I, _F, _P],
    "cdae_norm_act_bwd": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _L, _I, _I, _I, _P],
    "cdae_norm_act_plan": [_I, _L, _I, _I, _I, ctypes.POINTER(_I)],
}
DTYPES = (torch.bfloat16, torch.float32)


def _fn(name: str):
    """The C entry ``name`` of ``csrc/norm_act.cu``, built and typed on first use."""
    fn = getattr(_build.load("norm_act"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None, silu: bool = False) -> torch.Tensor:
    """The eager chain (plain version of the forward kernel): mean and E[x^2]
    in fp32, var = E[x^2] - E[x]^2, the affine in fp32, a cast back to x's
    dtype, then ``y * (1 + scale) + shift`` and ``y * sigmoid(y)`` in it."""
    orig_dtype = x.dtype
    B, C = x.shape[:2]
    G = groups
    x32 = x.float().reshape(B, G, -1)
    mean = x32.mean(dim=-1, keepdim=True)
    msq = (x32 * x32).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(msq - mean * mean + eps)
    y = ((x32 - mean) * inv).reshape(x.shape)
    bshape = (1, C) + (1,) * (x.ndim - 2)
    y = y * weight.reshape(bshape) + bias.reshape(bshape)
    y = y.to(orig_dtype)
    if scale is not None:
        cshape = (B, C) + (1,) * (x.ndim - 2)
        y = y * (1 + scale.to(orig_dtype).reshape(cshape)) + shift.to(orig_dtype).reshape(cshape)
    if silu:
        y = y * torch.sigmoid(y)
    return y


def norm_act_stats_plain(x: torch.Tensor, groups: int, eps: float):
    """The group statistics the forward kernel saves: fp32 mean and rstd [B, G]."""
    x32 = x.float().reshape(x.shape[0], groups, -1)
    mean = x32.mean(dim=-1)
    msq = (x32 * x32).mean(dim=-1)
    return mean, torch.rsqrt(msq - mean * mean + eps)


def norm_act_bwd_plain(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float,
                       scale: Optional[torch.Tensor] = None,
                       shift: Optional[torch.Tensor] = None, silu: bool = False,
                       stats=None):
    """Plain version of the backward kernel: ``(dx, d_weight, d_bias, d_scale,
    d_shift)`` from x and the output's gradient ``dy``.

    The kernel's formula in fp32: the pre-activation z and the affine output
    y1 recomputed at the forward's rounding points; dy through the SiLU,
    ``s (1 + z (1 - s))`` with s the fp32 sigmoid of z; d_shift and d_scale
    its sums per (b, c) (with y1); g1 = that times ``T(1 + scale)``; d_bias
    and d_weight the sums of g1 and g1 x-hat per channel; dx = rstd (g1 w -
    mean(g1 w) - x-hat mean(g1 w x-hat)) over each group. dx is rounded to
    x's dtype, d_scale and d_shift to theirs; d_weight and d_bias stay fp32.
    d_scale and d_shift are None without a scale-shift. ``stats``, the fp32
    (mean, rstd) [B, G] to use, as the kernel takes the forward's; recomputed
    from x where None.
    """
    dt = x.dtype
    B, C = x.shape[:2]
    G = groups
    x32 = x.float().reshape(B, G, -1)
    mean, rstd = stats if stats is not None else norm_act_stats_plain(x, groups, eps)
    mean, rstd = mean[..., None], rstd[..., None]
    xh = ((x32 - mean) * rstd).reshape(B, C, -1)
    y1 = (xh * weight[:, None] + bias[:, None]).to(dt)
    z = y1
    if scale is not None:
        sp = 1 + scale.to(dt)[:, :, None]
        z = y1 * sp + shift.to(dt)[:, :, None]
    g = dy.float().reshape(B, C, -1)
    if silu:
        s = torch.sigmoid(z.float())
        g = g * (s * (1 + z.float() * (1 - s)))
    d_scale = d_shift = None
    if scale is not None:
        d_shift = g.sum(-1).to(shift.dtype)
        d_scale = (g * y1.float()).sum(-1).to(scale.dtype)
        g = g * sp.float()
    d_bias = g.sum((0, 2))
    d_weight = (g * xh).sum((0, 2))
    gw = (g * weight[:, None]).reshape(B, G, -1)
    xg = xh.reshape(B, G, -1)
    dx = rstd * (gw - gw.mean(-1, keepdim=True) - xg * (gw * xg).mean(-1, keepdim=True))
    return dx.reshape(x.shape).to(dt), d_weight, d_bias, d_scale, d_shift


def _check(x, weight, bias, groups, scale, shift) -> None:
    """Raise on anything the kernels do not take."""
    if x.dtype not in DTYPES:
        raise TypeError(f"the norm kernels take bfloat16 or float32, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0 or x.shape[1] % groups:
        raise ValueError(f"x must be a non-empty [B, C, ...] with C divisible by {groups} "
                         f"groups, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, got strides {x.stride()}")
    C = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 [{C}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if scale is not None:
        for name, t in (("scale", scale), ("shift", shift)):
            if t.dtype != x.dtype or t.shape != (x.shape[0], C) or t.stride(1) != 1 \
                    or t.device != x.device:
                raise ValueError(f"{name} must be {x.dtype} [{x.shape[0]}, {C}] on {x.device} "
                                 f"with a contiguous channel axis, got {t.dtype} "
                                 f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
        if scale.stride(0) != shift.stride(0):
            raise ValueError(f"scale and shift need one row stride, got {scale.stride(0)} "
                             f"and {shift.stride(0)}")


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Call ``name`` on x's card and current stream; raise on its return code."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(name, x, *args)
    rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + ("arguments the kernel does not take" if rc == -1
                              else f"CUDA error {rc}"))


def norm_act_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                 eps: float, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, silu: bool = False,
                 with_stats: bool = False):
    """The forward kernel's wrapper: plain version on the CPU, the CUDA kernel on the card.

    Returns the output (x's shape and dtype), and with ``with_stats`` also
    the fp32 mean and rstd [B, G] that the backward reads.
    """
    if x.device.type == "cpu":
        y = norm_act_plain(x, weight, bias, groups, eps, scale, shift, silu)
        return (y, *norm_act_stats_plain(x, groups, eps)) if with_stats else y
    if x.device.type != "cuda":
        raise ValueError(f"no norm kernel for device {x.device}")
    _check(x, weight, bias, groups, scale, shift)
    B, C = x.shape[:2]
    y = torch.empty_like(x)
    mean = rstd = None
    if with_stats:
        mean, rstd = torch.empty((2, B, groups), dtype=torch.float32, device=x.device)
    _launch("cdae_norm_act_fwd", x, x.data_ptr(), y.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            0 if scale is None else scale.stride(0),
            None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(),
            B, C, x.numel() // (B * C), groups, x.dtype == torch.bfloat16, silu, eps)
    norm_act_fwd.launches += 1
    return (y, mean, rstd) if with_stats else y


norm_act_fwd.launches = 0


def norm_act_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 groups: int, eps: float, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, silu: bool = False,
                 mean: torch.Tensor = None, rstd: torch.Tensor = None):
    """The backward kernel's wrapper: plain version on the CPU, the CUDA kernel on the card.

    Returns ``(dx, d_weight, d_bias, d_scale, d_shift)`` as
    :func:`norm_act_bwd_plain` does. ``mean`` and ``rstd`` are the forward
    kernel's statistics (``norm_act_fwd(.., with_stats=True)``); the kernel
    needs them, the plain version recomputes them.
    """
    if x.device.type == "cpu":
        return norm_act_bwd_plain(x, dy, weight, bias, groups, eps, scale, shift, silu)
    if x.device.type != "cuda":
        raise ValueError(f"no norm kernel for device {x.device}")
    _check(x, weight, bias, groups, scale, shift)
    B, C = x.shape[:2]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"dy must be a contiguous {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"got {dy.dtype} {tuple(dy.shape)} strides {dy.stride()}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t is None or t.dtype != torch.float32 or t.shape != (B, groups) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"the backward kernel needs the forward kernel's {name}, a "
                             f"contiguous float32 [{B}, {groups}] on {x.device}")
    dx = torch.empty_like(x)
    sums = torch.empty(2 * B * C + 2 * C, dtype=torch.float32, device=x.device)
    part, dwb = sums[:2 * B * C], sums[2 * B * C:].view(2, C)
    d_scale = d_shift = dss = None
    if scale is not None:
        d_shift, d_scale = dss = torch.empty((2, B, C), dtype=scale.dtype, device=x.device)
    _launch("cdae_norm_act_bwd", x, x.data_ptr(), dy.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            0 if scale is None else scale.stride(0), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), None if dss is None else d_scale.data_ptr(),
            None if dss is None else d_shift.data_ptr(), part.data_ptr(), dwb.data_ptr(),
            B, C, x.numel() // (B * C), groups, x.dtype == torch.bfloat16, silu)
    norm_act_bwd.launches += 1
    return dx, dwb[0], dwb[1], d_scale, d_shift


norm_act_bwd.launches = 0
tracing.counters_from(lambda: {"cdae.norm_act_fwd.launches": norm_act_fwd.launches,
                               "cdae.norm_act_bwd.launches": norm_act_bwd.launches})


def plan(C: int, S: int, groups: int, dtype: torch.dtype, aligned: bool = True) -> dict:
    """The kernels' split of one group of a [B, C, S] tensor (on a card):
    16-byte chunks or single elements, the cluster's blocks, the threads of
    a block and the chunks each thread takes. The launches choose it in C;
    this reads it for ``chip_smoke.py``'s records and the card tests."""
    out = (_I * 4)()
    if _fn("cdae_norm_act_plan")(C, S, groups, dtype == torch.bfloat16, aligned, out) != 0:
        raise ValueError(f"no plan for C={C}, S={S}, groups={groups}")
    return {"vec": bool(out[0]), "cluster": out[1], "threads": out[2], "slots": out[3]}


@torch.library.custom_op("causaldiffae::norm_act_fwd", mutates_args=())
def norm_act_fwd_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], groups: int,
                    eps: float, silu: bool) -> torch.Tensor:
    """The forward as a dispatcher op: :func:`norm_act_fwd` as the eager path
    (:func:`group_norm_act`) calls it, so that a program traced from the model
    gives the eager call's bits. A compiled graph may hand it another layout,
    such as channels-last: on a card x is made contiguous, as the eager path
    makes it, and the output is contiguous; on the CPU the plain version
    takes x as it is, so its values and its output's layout are the eager
    call's (the layout follows x's where a group's channels view as one
    row, and is contiguous where they are copied). The fake gives each
    layout as the implementation does: AOTInductor reads the output by the
    fake's strides."""
    if x.device.type == "cuda":
        x = x.contiguous()
    return norm_act_fwd(x, weight, bias, groups, eps, scale, shift, silu)


@norm_act_fwd_op.register_fake
def _(x, weight, bias, scale, shift, groups, eps, silu):
    # shapes and layout only: on the CPU the plain version's own, traced on the fake x
    if x.device.type == "cuda":
        return x.new_empty(x.shape)
    return norm_act_plain(x, weight, bias, groups, eps, scale, shift, silu)


class NormAct(torch.autograd.Function):
    """The chain with the forward kernel forward and the backward kernel
    backward; it saves x, weight, bias, scale, shift and the fp32 statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, groups: int, eps: float, silu: bool):
        y, mean, rstd = norm_act_fwd(x, weight, bias, groups, eps, scale, shift, silu, True)
        ctx.save_for_backward(x, weight, bias, scale, shift, mean, rstd)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, scale, shift, mean, rstd = ctx.saved_tensors
        dx, d_weight, d_bias, d_scale, d_shift = norm_act_bwd(
            x, dy.contiguous(), weight, bias, ctx.groups, ctx.eps, scale, shift, ctx.silu,
            mean, rstd)
        return dx, d_weight, d_bias, d_scale, d_shift, None, None, None


_compiling = torch.compiler.is_compiling
_exporting = torch.compiler.is_exporting


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None, silu: bool = False,
                   use_kernels: bool = True) -> torch.Tensor:
    """``GroupNorm32``'s chain, by the module's rule: without ``use_kernels``
    the eager chain; with it, under ``torch.export`` or ``torch.compile`` the
    op, else on a card the kernels (``NormAct`` where a gradient is needed,
    else the forward kernel) and on the CPU the eager chain."""
    if scale is not None and scale.dtype != x.dtype:
        scale, shift = scale.to(x.dtype), shift.to(x.dtype)
    if not use_kernels:
        return norm_act_plain(x, weight, bias, groups, eps, scale, shift, silu)
    grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad
        or (scale is not None and (scale.requires_grad or shift.requires_grad)))
    if _compiling() or _exporting():
        if grad:
            raise RuntimeError("the norm kernels' backward runs from eager autograd only: trace "
                               "the model without a gradient, or build it with use_kernels off")
        return torch.ops.causaldiffae.norm_act_fwd(x, weight, bias, scale, shift, groups, eps,
                                                   silu)
    if x.device.type != "cuda":
        return norm_act_plain(x, weight, bias, groups, eps, scale, shift, silu)
    x = x.contiguous()
    if grad:
        return NormAct.apply(x, weight, bias, scale, shift, groups, eps, silu)
    return norm_act_fwd(x, weight, bias, groups, eps, scale, shift, silu)
