"""The port's attention against the JAX package's.

- ``causaldiffae_torch.models.attention.qkv_attention`` against the JAX
  einsum path ``causaldiffae_tpu.models.attention.qkv_attention``;
- the kernel's wrapper on CPU tensors (both entry names; it runs the plain
  version there) against the Pallas entries ``fused_qkv_attention`` and
  ``fused_qkv_attention_t`` in interpret mode, and against the einsum path;
- the block's routing; the wrapper's checks. (The kernel itself runs on
  the card only: ``tests/test_torch_cuda.py``.)

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: fp32 atol 2e-4, rtol 1e-3. bf16: the outputs are rounded to
bf16 (8 significant bits), so two implementations that sum in another order
may differ by one or two bf16 ulps: atol/rtol 2e-2 where both sides round at
the same points.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from causaldiffae_tpu.models.attention import qkv_attention as jax_qkv_attention
from causaldiffae_tpu.ops.attention_pallas import fused_qkv_attention as jax_fused
from causaldiffae_tpu.ops.attention_pallas import fused_qkv_attention_t as jax_fused_t
from causaldiffae_torch.models.attention import AttentionBlock, qkv_attention
from causaldiffae_torch.ops import attention as ops

B, H = 2, 2
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=2e-4, rtol=1e-3)
SHAPES = [(T, d) for T in (16, 49, 64) for d in (16, 32, 64)] + [
    (16, 128), (64, 128), (144, 128), (256, 64)]  # the circuit's and the pendulum's widths
EINSUM_SHAPES = [(16, 16), (49, 32), (64, 64)]


def _qkv(T, d, seed=0):
    return np.random.RandomState(seed).randn(B, T, 3 * H * d).astype(np.float32)


def _pair(x, dtype):
    """The same values as a jax and a torch array of ``dtype`` (bf16 rounded once)."""
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return j, t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,d", EINSUM_SHAPES)
def test_qkv_attention_matches_jax_einsum(T, d, dtype):
    j, t = _pair(_qkv(T, d), dtype)
    want = _np(jax_qkv_attention(j, H))
    got = _np(qkv_attention(t, H))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,d", SHAPES)
def test_kernel_entries_match_pallas_interpret(T, d, dtype):
    """Both port entries (CPU -> plain version) against both Pallas kernels."""
    j, t = _pair(_qkv(T, d, seed=1), dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want = _np(jax_fused(j, H, True))
    np.testing.assert_allclose(_np(jax_fused_t(j, H, True)), want, **tol)
    for entry in (ops.fused_qkv_attention, ops.fused_qkv_attention_t):
        got = entry(t, H)
        assert got.dtype == dtype and got.shape == (B, T, H * d)
        np.testing.assert_allclose(_np(got), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_wrapper_matches_jax_einsum(dtype):
    """The wrapper against the einsum path. In bf16 the two JAX paths round
    d^-1/4 differently at d=32 (0.421875 vs 0.419921875, ~1% on the
    scores) and the einsum path also rounds the scores to bf16, so the bf16
    bound is 5e-2 absolute on unit-variance inputs."""
    T, d = 49, 32
    j, t = _pair(_qkv(T, d, seed=2), dtype)
    want = _np(jax_qkv_attention(j, H))
    tol = F32_TOL if dtype == torch.float32 else dict(atol=5e-2, rtol=0)
    for entry in (ops.fused_qkv_attention, ops.fused_qkv_attention_t):
        np.testing.assert_allclose(_np(entry(t, H)), want, **tol)


def test_rounding_scale_is_sum_of_p_abs_v():
    """The kernel's error scale against sum_j p_j |v_j| in float64; it never
    falls below the output's magnitude (bf16 sums: within 2^-7)."""
    T, d = 49, 32
    t = torch.from_numpy(_qkv(T, d, seed=4)).to(torch.bfloat16)
    q, k, v = t.reshape(B, T, H, 3 * d).split(d, dim=-1)
    scale = ops.kernel_scale(d, torch.bfloat16)
    p = torch.softmax(torch.einsum("bthd,bshd->bhts", (q * scale).double(),
                                   (k * scale).double()), dim=-1)
    want = torch.einsum("bhts,bshd->bthd", p, v.double().abs()).reshape(B, T, H * d)
    got = ops.rounding_scale(t, H)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=2 ** -7, atol=0)
    assert bool((got >= ops.attention_plain(t, H).float().abs() * (1 - 2 ** -7)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,d", [(49, 32), (64, 64)])
def test_plain_lse_matches_logsumexp_of_jax_scores(T, d, dtype):
    """The plain version's row logsumexp against torch.logsumexp of its own
    scores and against jax.nn.logsumexp of the scores the Pallas kernels form
    (q and k scaled by dtype(d^-1/4), products summed in fp32)."""
    x = _qkv(T, d, seed=5) * 2 ** 0.5
    j, t = _pair(x, dtype)
    out, lse = ops.attention_plain(t, H, True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    torch.testing.assert_close(out, ops.attention_plain(t, H), atol=0, rtol=0)
    q, k, _ = t.reshape(B, T, H, 3 * d).split(d, dim=-1)
    sc = ops.kernel_scale(d, dtype)
    s = torch.einsum("bthd,bshd->bhts", (q * sc).float(), (k * sc).float())
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=0, rtol=0)
    jq, jk, _ = jnp.split(j.reshape(B, T, H, 3 * d), 3, axis=-1)
    js = jnp.asarray(1.0 / d ** 0.25, j.dtype)
    scores = jnp.einsum("bthd,bshd->bhts", (jq * js).astype(jnp.float32),
                        (jk * js).astype(jnp.float32))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(scores, axis=-1)),
                               rtol=1e-5, atol=1e-5)


def test_plain_version_scale_is_pallas_rounding():
    """bf16(d^-1/4) as the Pallas kernels round it, not 1/bf16(d^1/4)."""
    assert float(ops.kernel_scale(32, torch.bfloat16)) == 0.419921875
    assert float(ops.kernel_scale(64, torch.bfloat16)) == 0.353515625


@pytest.mark.parametrize("C,heads,dtype,expect", [
    (64, 2, torch.bfloat16, "t"),        # head_dim 32 -> the _t entry
    (128, 2, torch.bfloat16, "hm"),      # head_dim 64 -> the head-major entry
    (64, 2, torch.float32, "einsum"),    # fp32 -> qkv_attention
])
def test_attention_block_routing(monkeypatch, C, heads, dtype, expect):
    import causaldiffae_torch.models.attention as attn_mod

    calls = []
    monkeypatch.setattr(attn_mod, "fused_qkv_attention_t",
                        lambda q, h: calls.append("t") or ops.attention_plain(q, h))
    monkeypatch.setattr(attn_mod, "fused_qkv_attention",
                        lambda q, h: calls.append("hm") or ops.attention_plain(q, h))
    real = attn_mod.qkv_attention
    monkeypatch.setattr(attn_mod, "qkv_attention",
                        lambda q, h, scale=None: calls.append("einsum") or real(q, h, scale))
    block = AttentionBlock(C, heads, use_kernels=True, dtype=dtype)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, C, 7, 7).astype(np.float32)).to(dtype)
    out = block(x)
    assert out.shape == x.shape and calls == [expect]


def test_kernel_checks_reject_what_it_does_not_take():
    good = torch.zeros(2, 49, 3 * 64, dtype=torch.bfloat16)
    assert ops._check(good, 2) == 32
    with pytest.raises(TypeError):
        ops._check(good.float(), 2)
    with pytest.raises(ValueError):      # head width 16 has no kernel
        ops._check(torch.zeros(2, 49, 96, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError):      # channel axis not contiguous
        ops._check(torch.zeros(2, 192, 49, dtype=torch.bfloat16).transpose(1, 2), 2)
    with pytest.raises(ValueError):      # not [B, T, 3C]
        ops._check(torch.zeros(49, 192, dtype=torch.bfloat16), 2)
