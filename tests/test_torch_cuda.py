"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held against its plain PyTorch version on the same inputs.
bf16 bound, forward: |kernel - plain| <= 1e-4 + 1.6e-2 * sum_j p_j |v_j| --
the kernel rounds the unnormalised probabilities where the plain version
rounds the normalised ones, and both round the output, so the two may differ
by two bf16 ulps (2^-6) of the magnitude of the terms each output sums
(``ops.rounding_scale``). Backward: the same 1e-4 + 1.6e-2 * M, with M the
plain backward on the absolute values of its terms
(``ops.bwd_rounding_scale``): each version rounds p, ds and the output to
bf16 once, and one ulp apart at a term and at the output is 2^-6 of M.
The backward kernel is fed the forward kernel's output and row logsumexp
(lse), as the training path feeds it; lse is held against the plain fp32
logsumexp within rtol = atol = 1e-5 (exp2 and fp32 sums in another order).
"""

import pytest
import torch

from _port_fixtures import cuda_device  # noqa: F401  (fixture)
from causaldiffae_torch.ops import attention as ops

ATOL, RTOL = 1e-4, 1.6e-2


def _assert_within_rounding(got, qkv, h):
    err = (got.float() - ops.attention_plain(qkv, h).float()).abs()
    limit = ATOL + RTOL * ops.rounding_scale(qkv, h)
    assert bool((err <= limit).all()), f"max abs err {float(err.max())}"


def _qkv(b, T, h, d, device, seed=0, std=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (std * torch.randn(b, T, 3 * h * d, generator=g, device=device)).to(torch.bfloat16)


# the circuit's and the pendulum's training shapes (T=256 d=64; d=128 at T=64, 16, 144)
OTHER_PRESET_SHAPES = [(16, 256, 4, 64), (16, 64, 4, 128), (16, 16, 4, 128), (32, 144, 4, 128)]
# d = 128 tails: one key, one past a tile, one past two (T = 144's neighbour), 4 tiles;
# the 2-stage ring refills a stage at T > 128
D128_TAILS = [(2, 1, 2, 128), (2, 65, 2, 128), (2, 129, 2, 128), (2, 200, 2, 128)]
PENDULUM_TRAIN = (32, 144, 4, 128)
BWD_SHAPES = [(16, 784, 4, 32), (16, 49, 4, 64), (3, 100, 2, 64), (2, 77, 2, 128),
              # tails: the tensor maps' zero fill and the batch boundary
              (3, 1, 2, 32), (2, 65, 2, 64), (2, 77, 3, 32), (3, 100, 2, 128),
              *OTHER_PRESET_SHAPES, *D128_TAILS]
LSE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,h,d", [
    (16, 784, 4, 32), (16, 49, 4, 64),          # the main path's shapes
    (8, 784, 4, 32), (8, 49, 4, 64),            # the NLL sweep's batch of 8
    (3, 100, 2, 64), (2, 77, 2, 128), (1, 1, 1, 32), (2, 64, 3, 32),
    *OTHER_PRESET_SHAPES, *D128_TAILS,
])
def test_attention_kernel_matches_plain(cuda_device, b, T, h, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = _qkv(b, T, h, d, cuda_device)
    n = ops.attention_fwd.launches
    got = ops.fused_qkv_attention(qkv, h)
    torch.cuda.synchronize()
    assert ops.attention_fwd.launches == n + 1
    assert got.shape == (b, T, h * d) and got.dtype == torch.bfloat16
    _assert_within_rounding(got, qkv, h)
    torch.testing.assert_close(ops.fused_qkv_attention_t(qkv, h), got, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,h,d", [
    (16, 784, 4, 32), (16, 49, 4, 64), (3, 1, 2, 32), (2, 65, 2, 64), (2, 77, 3, 32),
    (3, 100, 2, 128), *OTHER_PRESET_SHAPES, *D128_TAILS,
])
def test_attention_kernel_lse_matches_plain(cuda_device, b, T, h, d):
    qkv = _qkv(b, T, h, d, cuda_device, seed=2, std=2 ** 0.5)
    n, n_lse = ops.attention_fwd.launches, ops.attention_fwd.lse_launches
    out, lse = ops.attention_fwd(qkv, h, True)
    plain = ops.attention_fwd(qkv, h)
    torch.cuda.synchronize()
    assert (ops.attention_fwd.launches - n, ops.attention_fwd.lse_launches - n_lse) == (2, 1)
    assert lse.shape == (b, h, T) and lse.dtype == torch.float32
    torch.testing.assert_close(out, plain, atol=0, rtol=0)
    torch.testing.assert_close(lse, ops.attention_plain(qkv, h, True)[1], **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,h,d", [(2, 49, 4, 64), (2, 144, 2, 128)])
def test_attention_kernel_takes_row_strided_views(cuda_device, b, T, h, d):
    """A token axis with a row stride larger than 3C (a view into a wider buffer)."""
    wide = _qkv(b, T, h, d + 8, cuda_device, seed=1)       # [b, T, 3*h*(d+8)]
    qkv = wide[..., :3 * h * d]
    assert not qkv.is_contiguous()
    got, lse = ops.attention_fwd(qkv, h, True)
    want, want_lse = ops.attention_fwd(qkv.contiguous(), h, True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)


@pytest.mark.cuda
def test_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    qkv = _qkv(2, 49, 2, 32, cuda_device)
    with pytest.raises(TypeError):
        ops.attention_fwd(qkv.float(), 2)
    with pytest.raises(ValueError):
        ops.attention_fwd(_qkv(2, 49, 2, 16, cuda_device), 2)


def _bwd_inputs(b, T, h, d, device):
    """qkv whose scores have std ~2 (q, k of std 2^(1/2) d^(1/4) after the
    d^-1/4 scaling: a softmax far from uniform), and a unit-variance g."""
    qkv = _qkv(b, T, h, d, device, seed=3, std=2 ** 0.5)
    gen = torch.Generator(device=device).manual_seed(4)
    g = torch.randn(b, T, h * d, generator=gen, device=device).to(torch.bfloat16)
    return qkv, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,h,d", BWD_SHAPES)
def test_attention_bwd_kernel_matches_plain(cuda_device, b, T, h, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, g = _bwd_inputs(b, T, h, d, cuda_device)
    out, lse = ops.attention_fwd(qkv, h, True)
    n = ops.attention_bwd.launches
    got = ops.attention_bwd(qkv, g, h, out, lse)
    torch.cuda.synchronize()
    assert ops.attention_bwd.launches == n + 1
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    err = (got.float() - ops.attention_bwd_plain(qkv, g, h).float()).abs()
    limit = ATOL + RTOL * ops.bwd_rounding_scale(qkv, g, h)
    assert bool((err <= limit).all()), f"max abs err {float(err.max())}"
    torch.testing.assert_close(ops.attention_bwd(qkv, g, h, out, lse), got,
                               atol=0, rtol=0)  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,h,d", [(2, 77, 2, 32), (2, 144, 2, 128)])
def test_attention_bwd_kernel_takes_row_strided_views(cuda_device, b, T, h, d):
    """qkv and g as views into wider buffers (row strides larger than 3C and C)."""
    wide, gw = _bwd_inputs(b, T, h, d + 16, cuda_device)
    qkv, g = wide[..., :3 * h * d], gw[..., :h * d]
    assert not qkv.is_contiguous() and not g.is_contiguous()
    out, lse = ops.attention_fwd(qkv, h, True)
    got = ops.attention_bwd(qkv, g, h, out, lse)
    qc, gc = qkv.contiguous(), g.contiguous()
    oc, lc = ops.attention_fwd(qc, h, True)
    torch.testing.assert_close(got, ops.attention_bwd(qc, gc, h, oc, lc), atol=0, rtol=0)


@pytest.mark.cuda
def test_attention_bwd_launches_are_bit_equal_at_the_pendulum_shape(cuda_device):
    """Two kernels and no atomics: every launch on the same inputs gives the
    same bits, the D scratch included (read by the dk/dv kernel)."""
    b, T, h, d = PENDULUM_TRAIN
    qkv, g = _bwd_inputs(b, T, h, d, cuda_device)
    out, lse = ops.attention_fwd(qkv, h, True)
    first = ops.attention_bwd(qkv, g, h, out, lse)
    for _ in range(3):
        torch.testing.assert_close(ops.attention_bwd(qkv, g, h, out, lse), first, atol=0, rtol=0)


@pytest.mark.cuda
def test_d_from_kernel_output_is_within_its_bound(cuda_device):
    """D = rowsum(g o), which the backward kernel takes from the forward
    kernel's bf16 output, stays within 2^-9 sum_j p_j (|g| . |v_j|) of K2's
    rowsum(p dp) per row on the flagship's head shape, as
    test_torch_attention_bwd.py shows on the CPU for the plain output."""
    b, T, h, d = 2, 784, 4, 32
    qkv, g = _bwd_inputs(b, T, h, d, cuda_device)
    o = ops.attention_fwd(qkv, h).reshape(b, T, h, d).double()
    q, k, v = qkv.reshape(b, T, h, 3 * d).split(d, dim=-1)
    sc = ops.kernel_scale(d, torch.bfloat16).to(cuda_device)
    p = torch.softmax(torch.einsum("bthd,bshd->bhts", (q * sc).double(), (k * sc).double()), -1)
    gd, vd = g.reshape(b, T, h, d).double(), v.double()
    want = (p * torch.einsum("bthd,bshd->bhts", gd, vd)).sum(-1)          # rowsum(p dp)
    got = torch.einsum("bthd,bthd->bht", gd, o)                          # rowsum(g o)
    bound = 2 ** -9 * (p * torch.einsum("bthd,bshd->bhts", gd.abs(), vd.abs())).sum(-1)
    ratio = float(((got - want).abs() / bound).max())
    assert ratio <= 1.0, ratio


@pytest.mark.cuda
def test_fused_attention_gradient_matches_plain_route(cuda_device):
    """autograd through the Function (both kernels) against autograd through
    the plain forward and the plain backward on the same inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, T, h, d = 4, 196, 2, 32
    qkv, g = _bwd_inputs(b, T, h, d, cuda_device)
    leaf = qkv.clone().requires_grad_(True)
    nf, nb = ops.attention_fwd.launches, ops.attention_bwd.launches
    out = ops.fused_qkv_attention_t(leaf, h)
    (grad,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    assert (ops.attention_fwd.launches - nf, ops.attention_bwd.launches - nb) == (1, 1)
    err = (grad.float() - ops.attention_bwd_plain(qkv, g, h).float()).abs()
    assert bool((err <= ATOL + RTOL * ops.bwd_rounding_scale(qkv, g, h)).all()), float(err.max())


@pytest.mark.cuda
def test_attention_bwd_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    qkv, g = _bwd_inputs(2, 49, 2, 32, cuda_device)
    out, lse = ops.attention_fwd(qkv, 2, True)
    with pytest.raises(ValueError):      # g of the wrong width
        ops.attention_bwd(qkv, g[..., :32], 2, out, lse)
    with pytest.raises(ValueError):      # g with a strided channel axis
        ops.attention_bwd(qkv, g.transpose(1, 2).contiguous().transpose(1, 2), 2, out, lse)
    with pytest.raises(TypeError):
        ops.attention_bwd(qkv.float(), g.float(), 2, out, lse)
    with pytest.raises(ValueError):      # no forward output and lse
        ops.attention_bwd(qkv, g, 2)
    with pytest.raises(ValueError):      # lse not in the forward kernel's layout
        ops.attention_bwd(qkv, g, 2, out, lse.contiguous())
