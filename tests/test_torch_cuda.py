"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held against its plain PyTorch version on the same inputs.
bf16 bound: |kernel - plain| <= 1e-4 + 1.6e-2 * sum_j p_j |v_j| -- the
kernel rounds the unnormalised probabilities where the plain version rounds
the normalised ones, and both round the output, so the two may differ by
two bf16 ulps (2^-6) of the magnitude of the terms each output sums
(``ops.rounding_scale``).
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


def _qkv(b, T, h, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, T, 3 * h * d, generator=g, device=device).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,h,d", [
    (16, 784, 4, 32), (16, 49, 4, 64),          # the main path's shapes
    (3, 100, 2, 64), (2, 77, 2, 128), (1, 1, 1, 32), (2, 64, 3, 32), (2, 65, 2, 128),
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
def test_attention_kernel_takes_row_strided_views(cuda_device):
    """A token axis with a row stride larger than 3C (a view into a wider buffer)."""
    b, T, h, d = 2, 49, 4, 64
    wide = _qkv(b, T, h, d + 8, cuda_device, seed=1)       # [b, T, 3*h*(d+8)]
    qkv = wide[..., :3 * h * d]
    assert not qkv.is_contiguous()
    got = ops.attention_fwd(qkv, h)
    torch.testing.assert_close(got, ops.attention_fwd(qkv.contiguous(), h), atol=0, rtol=0)


@pytest.mark.cuda
def test_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    qkv = _qkv(2, 49, 2, 32, cuda_device)
    with pytest.raises(TypeError):
        ops.attention_fwd(qkv.float(), 2)
    with pytest.raises(ValueError):
        ops.attention_fwd(_qkv(2, 49, 2, 16, cuda_device), 2)
