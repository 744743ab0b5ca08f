"""The port's attention backward against the JAX package's.

- ``attention_bwd_plain`` and the autograd ``FusedAttention`` Function on CPU
  tensors (where the wrappers run the plain versions) against ``jax.vjp`` of
  the Pallas entries ``fused_qkv_attention`` (K2 is its VJP) and
  ``fused_qkv_attention_t`` (K4) in interpret mode, the JAX package's own CPU
  route, at T in {16, 49, 64}, d in {32, 64}, and at the circuit's and the
  pendulum's (T, d) = (16 | 64 | 144, 128) and (256, 64), fp32 and bf16;
- the plain backward and its fp64 form ``attention_bwd_exact`` against torch
  autograd through the einsum path ``qkv_attention`` in fp32, and the bf16
  routing of a block's gradient.
(The kernel itself runs on the card only: ``tests/test_torch_cuda.py``.)

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: fp32 atol 2e-4, rtol 1e-3. bf16: both sides round p, ds and the
three gradients to bf16 at the same points but sum in other orders, so a
rounding may land one ulp apart, at a term and at the output:
|port - jax| <= 1e-4 + 1.6e-2 * M, with M the backward on the absolute
values of its terms (``ops.bwd_rounding_scale``, two bf16 ulps = 2^-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from causaldiffae_tpu.ops.attention_pallas import fused_qkv_attention as jax_fused
from causaldiffae_tpu.ops.attention_pallas import fused_qkv_attention_t as jax_fused_t
from causaldiffae_torch.models.attention import AttentionBlock, qkv_attention
from causaldiffae_torch.ops import attention as ops

B, H = 2, 2
F32_TOL = dict(atol=2e-4, rtol=1e-3)
BF16_ATOL, BF16_RTOL = 1e-4, 1.6e-2
SHAPES = [(T, d) for T in (16, 49, 64) for d in (32, 64)] + [
    (16, 128), (64, 128), (144, 128), (256, 64)]  # the circuit's and the pendulum's widths


def _inputs(T, d, seed):
    """qkv with scores of std ~2 (a softmax far from uniform) and a unit g."""
    rng = np.random.RandomState(seed)
    qkv = (2 ** 0.5 * rng.randn(B, T, 3 * H * d)).astype(np.float32)
    return qkv, rng.randn(B, T, H * d).astype(np.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _jax_vjp(entry, qkv, g):
    def vjp(q, g):
        return jax.vjp(lambda a: entry(a, H, True), q)[1](g)[0]

    return np.asarray(jnp.asarray(jax.jit(vjp)(qkv, g), jnp.float32))


def _assert_close(got, want, qkv, g, dtype):
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        limit = BF16_ATOL + BF16_RTOL * ops.bwd_rounding_scale(qkv, g, H).numpy()
        err = np.abs(got - want)
        assert (err <= limit).all(), (err.max(), (err / limit).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,d", SHAPES)
def test_backward_matches_pallas_vjps(T, d, dtype):
    """Plain backward and the Function's backward against K2's and K4's VJPs."""
    x, gx = _inputs(T, d, seed=T + d)
    qkv, g = _torch(x, dtype), _torch(gx, dtype)
    plain = ops.attention_bwd_plain(qkv, g, H)
    assert plain.dtype == dtype and plain.shape == qkv.shape
    leaf = qkv.clone().requires_grad_(True)
    (fn_grad,) = torch.autograd.grad(ops.fused_qkv_attention_t(leaf, H), leaf, g)
    torch.testing.assert_close(fn_grad, plain, atol=0, rtol=0)  # CPU: the plain version
    for entry in (jax_fused, jax_fused_t):
        _assert_close(plain, _jax_vjp(entry, _jax(x, dtype), _jax(gx, dtype)), qkv, g, dtype)


@pytest.mark.parametrize("T,d", [(16, 32), (49, 64)])
def test_backward_matches_einsum_autograd_fp32(T, d):
    x, gx = _inputs(T, d, seed=7)
    qkv, g = torch.from_numpy(x), torch.from_numpy(gx)
    leaf = qkv.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(qkv_attention(leaf, H), leaf, g)
    np.testing.assert_allclose(ops.attention_bwd_plain(qkv, g, H).numpy(), want.numpy(),
                               **F32_TOL)
    exact = ops.attention_bwd_exact(qkv, g, H)  # the fp64 yardstick of chip_smoke.py
    assert exact.dtype == torch.float64
    np.testing.assert_allclose(exact.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("requires_grad", [True, False])
def test_function_saves_output_and_lse_only_for_a_gradient(monkeypatch, requires_grad):
    """On the CPU the Function runs the plain versions; it asks the forward
    for lse only when qkv needs a gradient, and then saves qkv, the output
    and lse; its backward hands the last two to the backward's wrapper."""
    x, gx = _inputs(49, 32, seed=9)
    qkv, g = _torch(x, torch.bfloat16), _torch(gx, torch.bfloat16)
    asked, handed = [], []
    real_fwd, real_bwd = ops.attention_fwd, ops.attention_bwd
    monkeypatch.setattr(ops, "attention_fwd", lambda *a: asked.append(a[2:]) or real_fwd(*a))
    monkeypatch.setattr(ops, "attention_bwd", lambda *a: handed.append(a[3:]) or real_bwd(*a))
    leaf = qkv.clone().requires_grad_(requires_grad)
    out = ops.fused_qkv_attention_t(leaf, H)
    torch.testing.assert_close(out.detach(), ops.attention_plain(qkv, H), atol=0, rtol=0)
    assert asked == [(True,)] if requires_grad else asked == [()]
    if not requires_grad:
        assert out.grad_fn is None
        return
    saved_qkv, saved_out, saved_lse = out.grad_fn.saved_tensors
    assert saved_qkv.shape == qkv.shape and torch.equal(saved_out, out.detach())
    torch.testing.assert_close(saved_lse, ops.attention_plain(qkv, H, True)[1], atol=0, rtol=0)
    (grad,) = torch.autograd.grad(out, leaf, g)
    assert len(handed) == 1 and torch.equal(handed[0][0], out.detach())
    torch.testing.assert_close(grad, ops.attention_bwd_plain(qkv, g, H), atol=0, rtol=0)


def test_d_from_rounded_output_is_within_its_bound():
    """The backward kernel takes D = rowsum(g o) from the forward's bf16 output
    where K2 forms D = rowsum(p dp) (attention_pallas.py:241). On the
    flagship's head shape (T=784, d=32, 4 heads, B=2) with scores of std ~2,
    the two stay within 2^-9 sum_j p_j (|g| . |v_j|) of each other per row:
    2^-9 of the D term of M (ops.bwd_rounding_scale), far inside the 2^-6 M
    bound. Worst case the roundings of p and of o add up to 2^-8; their signs
    vary, so the sum stays well below. o here is the plain version's, which
    rounds the normalised p; the forward kernel rounds the unnormalised p
    and normalises at the store: one rounding of each term and one of o all
    the same, so the same bound holds, and test_torch_cuda.py holds the
    kernel's own output to it on the card."""
    b, T, h, d = 2, 784, 4, 32
    rng = np.random.RandomState(12)
    x = (2 ** 0.5 * rng.randn(b, T, 3 * h * d)).astype(np.float32)
    qkv = torch.from_numpy(x).to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(b, T, h * d).astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv.reshape(b, T, h, 3 * d).split(d, dim=-1)
    sc = ops.kernel_scale(d, torch.bfloat16)
    p = torch.softmax(torch.einsum("bthd,bshd->bhts", (q * sc).double(), (k * sc).double()), -1)
    gd, vd = g.reshape(b, T, h, d).double(), v.double()
    want = (p * torch.einsum("bthd,bshd->bhts", gd, vd)).sum(-1)          # rowsum(p dp)
    o = ops.attention_plain(qkv, h).reshape(b, T, h, d).double()
    got = torch.einsum("bthd,bthd->bht", gd, o)                          # rowsum(g o)
    bound = 2 ** -9 * (p * torch.einsum("bthd,bshd->bhts", gd.abs(), vd.abs())).sum(-1)
    ratio = ((got - want).abs() / bound).max()
    assert float(ratio) <= 1.0, float(ratio)


@pytest.mark.parametrize("C,heads,dtype,through_function", [
    (64, 2, torch.bfloat16, True),       # head_dim 32, the _t entry
    (128, 2, torch.bfloat16, True),      # head_dim 64, the head-major entry
    (64, 2, torch.float32, False),       # fp32: plain autograd through qkv_attention
])
def test_block_gradient_routing(monkeypatch, C, heads, dtype, through_function):
    """A block's bf16 training pass differentiates through the Function's
    backward (the kernel's wrapper); fp32 through plain autograd."""
    calls = []
    real = ops.attention_bwd
    monkeypatch.setattr(ops, "attention_bwd", lambda *a: calls.append(1) or real(*a))
    block = AttentionBlock(C, heads, use_kernels=True, dtype=dtype)
    torch.nn.init.normal_(block.proj_out.weight, std=0.1)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, C, 7, 7).astype(np.float32))
    x = x.to(dtype).requires_grad_(True)
    block(x).float().square().sum().backward()
    assert len(calls) == int(through_function)
    assert block.qkv.weight.grad is not None and bool(torch.isfinite(block.qkv.weight.grad).all())
