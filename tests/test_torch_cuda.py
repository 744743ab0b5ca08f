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

The norm kernels (``ops/norm_act.py``) are held against the eager chain and
the plain fp32 backward formula at every shape the pendulum UNet's norms
see, with the bounds ``_check_norm`` states.
"""

import pytest
import torch

from _norm_reference import bwd_errors, bwd_magnitudes, chain_from_stats, ulp
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


@pytest.mark.cuda
def test_attention_op_launches_the_kernel(cuda_device):
    """``torch.ops.causaldiffae.attention_fwd`` (the op a serving artifact's
    graph calls) launches the kernel once per call, writes no lse, and gives
    the wrapper's output bit for bit; a no-grad ``fused_qkv_attention`` goes
    through it."""
    qkv = _qkv(16, 784, 4, 32, cuda_device, seed=3)
    n, lse = ops.attention_fwd.launches, ops.attention_fwd.lse_launches
    got = torch.ops.causaldiffae.attention_fwd(qkv, 4)
    with torch.no_grad():
        routed = ops.fused_qkv_attention_t(qkv, 4)
    torch.cuda.synchronize()
    assert ops.attention_fwd.launches == n + 2 and ops.attention_fwd.lse_launches == lse
    want = ops.attention_fwd(qkv, 4)
    assert torch.equal(got, want) and torch.equal(routed, want)


# ---- GroupNorm + scale-shift + SiLU (ops/norm_act.py) --------------------
# Every distinct (C, spatial) of the pendulum UNet's 62 GroupNorm32 calls in
# bf16 (the token axis of its 12x12 attention block as (512, (144,))); the
# fp32 output norm is (128, (96, 96)) in float32 below.
PENDULUM_NORMS = [(128, (48, 48)), (128, (96, 96)), (256, (24, 24)), (256, (48, 48)),
                  (256, (96, 96)), (384, (12, 12)), (384, (24, 24)), (384, (48, 48)),
                  (384, (96, 96)), (512, (12, 12)), (512, (48, 48)), (512, (144,)),
                  (640, (24, 24)), (640, (48, 48)), (768, (24, 24)), (896, (12, 12)),
                  (896, (24, 24)), (1024, (12, 12))]
FLAGS = [(True, True), (False, True), (False, False)]   # (scale-shift, SiLU)


def _norm_inputs(B, C, spatial, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(B, C, *spatial, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    w = 1.0 + 0.2 * torch.randn(C, generator=g, device=device)
    b = 0.1 * torch.randn(C, generator=g, device=device)
    emb = (0.3 * torch.randn(B, 2 * C, generator=g, device=device)).to(dtype)
    scale, shift = torch.chunk(emb, 2, dim=-1)
    dy = torch.randn(B, C, *spatial, generator=g, device=device).to(dtype)
    return x, w, b, scale, shift, dy


def _check_norm(B, C, spatial, G, dtype, device, flags=FLAGS, seed=0):
    """Forward: the statistics within 1e-5 of the plain ones; on them the
    eager chain's elementwise ops give the kernel's output bit for bit (its
    rounding points); against the eager chain itself, in bf16 equal in >= 99%
    of elements and, where the output is the norm's own (no scale-shift, no
    SiLU), within one ulp at the scale of the affine's terms, |x-hat w| + |b|
    (the statistics' last bits move x-hat by ~1e-7 absolute, which is many
    ulps of an output that cancels to near 0; a flipped rounding can also
    grow through a shift that cancels, so with the scale-shift the share of
    equal elements is the check); in fp32 within 1e-5. Backward (fed the
    forward kernel's statistics): within one ulp of T (dx, d_scale, d_shift)
    plus 1e-4 of the magnitude of the terms (fp32 sums in another order) of
    the plain fp32 formula on the same statistics; d_weight, d_bias and dx
    equal across two runs."""
    from causaldiffae_torch.ops import norm_act as na

    x, w, b, scale0, shift0, dy = _norm_inputs(B, C, spatial, dtype, device, seed)
    for ss, silu in flags:
        scale, shift = (scale0, shift0) if ss else (None, None)
        nf, nb = na.norm_act_fwd.launches, na.norm_act_bwd.launches
        y, mean, rstd = na.norm_act_fwd(x, w, b, G, 1e-5, scale, shift, silu, with_stats=True)
        assert y.dtype == dtype and y.shape == x.shape
        pm, pr = na.norm_act_stats_plain(x, G, 1e-5)
        torch.testing.assert_close(mean, pm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rstd, pr, rtol=1e-5, atol=1e-5)
        chain = chain_from_stats(x, mean, rstd, w, b, scale, shift, silu)
        assert torch.equal(y, chain), (ss, silu)
        want = na.norm_act_plain(x, w, b, G, 1e-5, scale, shift, silu)
        diff = (y.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            equal = float((diff == 0).float().mean())
            assert equal >= 0.99, (ss, silu, equal)
            if not ss and not silu:   # one ulp at the scale of the affine's terms
                xh = (x.float().reshape(B, G, -1) - pm[..., None]) * pr[..., None]
                xh = xh.reshape(x.shape)
                bshape = (1, C) + (1,) * len(spatial)
                terms = (xh * w.reshape(bshape)).abs() + b.reshape(bshape).abs()
                assert bool((diff <= ulp(terms.to(dtype))).all()), float(diff.max())
        else:
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        got = na.norm_act_bwd(x, dy, w, b, G, 1e-5, scale, shift, silu, mean, rstd)
        again = na.norm_act_bwd(x, dy, w, b, G, 1e-5, scale, shift, silu, mean, rstd)
        torch.cuda.synchronize()
        assert (na.norm_act_fwd.launches - nf, na.norm_act_bwd.launches - nb) == (1, 2)
        assert all(torch.equal(a, c) for a, c in zip(got[:3], again[:3]))
        # the plain formula on the kernel's statistics, as the kernel reads them
        plain = na.norm_act_bwd_plain(x, dy, w, b, G, 1e-5, scale, shift, silu, (mean, rstd))
        mags = bwd_magnitudes(x, dy, w, b, scale, shift, silu, mean, rstd)
        excess = bwd_errors(got, plain, mags)
        assert all(e is None or e <= 0 for e in excess), (ss, silu, excess)
        assert (excess[3] is None) == (scale is None)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 32])
@pytest.mark.parametrize("C,spatial", PENDULUM_NORMS)
def test_norm_act_kernels_match_plain_at_pendulum_shapes(cuda_device, B, C, spatial):
    _check_norm(B, C, spatial, 32, torch.bfloat16, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 32])
def test_norm_act_kernels_fp32_output_norm(cuda_device, B):
    _check_norm(B, 128, (96, 96), 32, torch.float32, cuda_device, flags=[(False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("C,spatial,G,dtype", [
    (64, (96, 96), 16, torch.bfloat16), (128, (48, 48), 16, torch.bfloat16),   # tp = 2 shards
    (256, (12, 12), 16, torch.bfloat16), (512, (144,), 16, torch.bfloat16),
    (128, (14, 14), 32, torch.bfloat16), (256, (7, 7), 32, torch.bfloat16),   # single elements
    (512, (4, 4), 32, torch.bfloat16), (256, (128, 128), 32, torch.bfloat16),  # circuit
    (384, (96, 96), 32, torch.float32),    # past 8 blocks' registers: read again
    (96, (28, 28), 32, torch.float32),
])
def test_norm_act_kernels_other_shapes(cuda_device, C, spatial, G, dtype):
    _check_norm(4, C, spatial, G, dtype, cuda_device)


@pytest.mark.cuda
def test_norm_act_plan_follows_the_group_size(cuda_device):
    """The split: one block for a small group, a cluster of 8 for the largest."""
    from causaldiffae_torch.ops import norm_act as na

    assert na.plan(512, 144, 32, torch.bfloat16) == {"vec": True, "cluster": 1, "threads": 96,
                                                     "slots": 3}
    assert na.plan(256, 9216, 32, torch.bfloat16) == {"vec": True, "cluster": 8,
                                                      "threads": 288, "slots": 4}
    assert na.plan(384, 9216, 32, torch.float32)["slots"] > 4
    assert not na.plan(256, 49, 32, torch.bfloat16)["vec"]


@pytest.mark.cuda
def test_group_norm32_runs_the_kernels_through_autograd(cuda_device):
    """``GroupNorm32`` on a card: a no-grad call launches the forward kernel
    and gives the wrapper's output; with a gradient, ``NormAct``'s forward and
    backward kernels, whose gradients are the wrapper's; no call goes to a
    plain or library path."""
    from causaldiffae_torch.models import GroupNorm32
    from causaldiffae_torch.ops import norm_act as na

    x, w, b, scale, shift, dy = _norm_inputs(8, 256, (48, 48), torch.bfloat16, cuda_device, 5)
    norm = GroupNorm32(256).to(cuda_device)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    nf, nb = na.norm_act_fwd.launches, na.norm_act_bwd.launches
    with torch.no_grad():
        y0 = norm(x, (scale, shift), silu_after=True)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
    y = norm(leaves[0], (leaves[1], leaves[2]), silu_after=True)
    assert y.grad_fn is not None and "NormAct" in type(y.grad_fn).__name__
    y.backward(dy)
    torch.cuda.synchronize()
    assert (na.norm_act_fwd.launches - nf, na.norm_act_bwd.launches - nb) == (2, 1)
    assert torch.equal(y0, y.detach())
    y1, mean, rstd = na.norm_act_fwd(x, w, b, 32, 1e-5, scale, shift, True, with_stats=True)
    assert torch.equal(y0, y1)
    want = na.norm_act_bwd(x, dy, w, b, 32, 1e-5, scale, shift, True, mean, rstd)
    grads = (leaves[0].grad, norm.weight.grad, norm.bias.grad, leaves[1].grad, leaves[2].grad)
    assert all(torch.equal(g, v) for g, v in zip(grads, want))


@pytest.mark.cuda
def test_norm_op_takes_a_channels_last_x(cuda_device):
    """The op (what a compiled artifact calls) launches the kernel on a
    channels-last x, as Inductor may lay it out, and returns the kernel's
    contiguous output on the contiguous x, as the eager path does."""
    from causaldiffae_torch.ops import norm_act as na

    x, w, b, scale, shift, _ = _norm_inputs(4, 128, (24, 24), torch.bfloat16, cuda_device, 6)
    n = na.norm_act_fwd.launches
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got = torch.ops.causaldiffae.norm_act_fwd(x_cl, w, b, scale, shift, 32, 1e-5, True)
    torch.cuda.synchronize()
    assert na.norm_act_fwd.launches == n + 1 and got.is_contiguous()
    assert torch.equal(got, na.norm_act_fwd(x, w, b, 32, 1e-5, scale, shift, True))


@pytest.mark.cuda
def test_norm_act_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    from causaldiffae_torch.ops import norm_act as na

    x, w, b, scale, shift, dy = _norm_inputs(2, 64, (8, 8), torch.bfloat16, cuda_device)
    with pytest.raises(TypeError):
        na.norm_act_fwd(x.half(), w, b, 32, 1e-5)
    with pytest.raises(ValueError):     # a strided x
        na.norm_act_fwd(x.transpose(2, 3), w, b, 32, 1e-5)
    with pytest.raises(ValueError):     # weight on the CPU
        na.norm_act_fwd(x, w.cpu(), b, 32, 1e-5)
    with pytest.raises(ValueError):     # no statistics for the backward
        na.norm_act_bwd(x, dy, w, b, 32, 1e-5)
