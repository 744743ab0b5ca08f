"""The port's layers, UNet ``denoise``, encoder and SCM against flax.

Weights: a flax tree shaped by ``jax.eval_shape`` and filled from a numpy
seed (every parameter, the zero-initialised ones included), carried into the
port with ``state_dict_from_flax``. The flax side runs its einsum attention
path (``use_pallas=False``, the same math), the port its kernel wrapper,
which takes the plain version on CPU tensors.

Tolerances: fp32 atol 2e-4, rtol 1e-3 (encoder and SCM tighter). bf16: the
two frameworks round at different points (torch adds a conv's bias before
its one rounding, flax after; the einsum path rounds d^-1/4 and the scores
differently from the kernel's plain version), and one-ulp differences
compound through the network. On these weights the JAX package's own bf16
eps is ~3% RMS away from its fp32 eps, so a bf16 check bounds the error
relative to the output's scale, RMS(diff) <= 5e-2 * RMS(want) and
max|diff| <= 8e-2 * max|want|, and the bf16 UNet must be no further from
the fp32 result than 1.25x the JAX package's bf16 is. A real fault (a wrong
cast point, scale or weight) moves eps by O(1) relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import configs, flax_variables, port_model
from causaldiffae_tpu.models import layers as jl
from causaldiffae_tpu.models.attention import AttentionBlock as JaxAttentionBlock
from causaldiffae_tpu.models.unet import CausalUNet as JaxUNet
from causaldiffae_torch.models import layers as tl
from causaldiffae_torch.models.attention import AttentionBlock
from causaldiffae_torch.utils import weights as tw

F32_TOL = dict(atol=2e-4, rtol=1e-3)
DTYPES = [(False, torch.float32, jnp.float32), (True, torch.bfloat16, jnp.bfloat16)]
IDS = ["fp32", "bf16"]


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = got - want
    rms = lambda a: float(np.sqrt(np.mean(a * a)))
    assert rms(diff) <= 5e-2 * rms(want), (rms(diff), rms(want))
    assert np.abs(diff).max() <= 8e-2 * np.abs(want).max(), (np.abs(diff).max(), np.abs(want).max())


def _close(got, want, bf16):
    if bf16:
        _assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                                   **F32_TOL)


def _filled(shapes, seed, std=0.1):
    from _port_fixtures import _fill, _plain_dict

    return _fill(_plain_dict(shapes), np.random.RandomState(seed), std)


def _sub_state_dict(writer, p):
    """Run one of utils/weights.py's block writers and strip its prefix."""
    sd = {}
    writer(sd, "m", p)
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_timestep_embedding_matches():
    t = np.array([0, 1, 17, 249, 999], np.int32)
    for dim in (32, 33):
        want = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
        got = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bf16,tdt,jdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("scale_shift", [False, True], ids=["plain", "scale_shift"])
@torch.no_grad()
def test_groupnorm32_matches(bf16, tdt, jdt, scale_shift):
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(2, 7, 7, 64) + 1.0).astype(np.float32)
    ss = [rng.randn(2, 64).astype(np.float32) * 0.5 for _ in range(2)]
    gn = jl.GroupNorm32()
    params = {"params": {"scale": (1 + 0.1 * rng.randn(64)).astype(np.float32),
                         "bias": (0.1 * rng.randn(64)).astype(np.float32)}}
    j_ss = tuple(jnp.asarray(a, jdt) for a in ss) if scale_shift else None
    want = gn.apply(params, jnp.asarray(x, jdt), emb_scale_shift=j_ss, silu_after=True)
    port = tl.GroupNorm32(64)
    port.load_state_dict({"weight": torch.from_numpy(params["params"]["scale"]),
                          "bias": torch.from_numpy(params["params"]["bias"])})
    t_ss = tuple(torch.from_numpy(a).to(tdt) for a in ss) if scale_shift else None
    got = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), scale_shift=t_ss,
               silu_after=True)
    assert got.dtype == tdt
    # one bf16 rounding each side at the same points: 1-2 ulps
    tol = F32_TOL if not bf16 else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("bf16,tdt,jdt", DTYPES, ids=IDS)
@torch.no_grad()
def test_resblock_matches(bf16, tdt, jdt):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 7, 32).astype(np.float32)
    emb = rng.randn(2, 128).astype(np.float32)
    block = jl.ResBlock(channels=32, emb_channels=128, out_channels=64,
                        use_scale_shift_norm=True, dtype=jdt)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x, jdt),
                            jnp.asarray(emb, jdt))
    params = _filled(shapes, seed=2)
    want = block.apply(params, jnp.asarray(x, jdt), jnp.asarray(emb, jdt))
    port = tl.ResBlock(32, 128, 64, use_scale_shift_norm=True, dtype=tdt)
    port.load_state_dict(_sub_state_dict(tw._resblock, params["params"]), strict=True)
    got = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), torch.from_numpy(emb).to(tdt))
    _close(got.permute(0, 2, 3, 1).float().numpy(), want, bf16)


@pytest.mark.parametrize("bf16,tdt,jdt", DTYPES, ids=IDS)
@torch.no_grad()
def test_attention_block_matches(bf16, tdt, jdt):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 7, 128).astype(np.float32)
    block = JaxAttentionBlock(channels=128, num_heads=4, use_pallas=False, dtype=jdt)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x, jdt))
    params = _filled(shapes, seed=4)
    want = block.apply(params, jnp.asarray(x, jdt))
    port = AttentionBlock(128, 4, use_kernels=True, dtype=tdt)
    port.load_state_dict(_sub_state_dict(tw._attention, params["params"]), strict=True)
    got = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).float().numpy(), want, bf16)


@pytest.fixture(scope="module", params=[False, True], ids=IDS)
def tiny(request):
    jax_cfg, port_cfg = configs(use_bf16=request.param)
    model, variables = flax_variables(jax_cfg)
    return request.param, model, variables, port_model(port_cfg, variables)


def _jax_denoise(model, variables, x, t, y, z):
    f = jax.jit(lambda v, x, t, y, z: model.apply(v, x, t, y=y, z=z, method=JaxUNet.denoise))
    return np.asarray(f(variables, x, t.astype(np.int32), y.astype(np.int32), z))


def test_denoise_matches(tiny):
    bf16, jmodel, variables, pmodel = tiny
    rng = np.random.RandomState(5)
    x = rng.randn(2, 28, 28, 1).astype(np.float32)
    t = np.array([3, 70], np.int64)
    y = np.array([1, 7], np.int64)
    z = rng.randn(2, 32).astype(np.float32)
    want = _jax_denoise(jmodel, variables, x, t, y, z)
    with torch.no_grad():
        got = pmodel.denoise(torch.from_numpy(x), torch.from_numpy(t), y=torch.from_numpy(y),
                             z=torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (2, 28, 28, 1)
    assert np.abs(want).max() > 0.1  # every block, attention included, reaches eps
    _close(got.numpy(), want, bf16)
    if bf16:
        from causaldiffae_tpu.config import create_model

        jax_cfg32 = configs(use_bf16=False)[0]
        want32 = _jax_denoise(create_model(jax_cfg32), variables, x, t, y, z)
        rms = lambda a: float(np.sqrt(np.mean(a * a)))
        assert rms(got.numpy() - want32) <= 1.25 * rms(want - want32)


def test_encode_and_causalize_match(tiny):
    bf16, jmodel, variables, pmodel = tiny
    rng = np.random.RandomState(6)
    x = np.clip(rng.randn(3, 28, 28, 1), -1, 1).astype(np.float32)
    mu_j, var_j = jax.jit(lambda v, x: jmodel.apply(v, x, method=JaxUNet.encode))(variables, x)
    with torch.no_grad():
        mu_p, var_p = pmodel.encode(torch.from_numpy(x))
    # fp32 heads after a bf16 or fp32 trunk: bf16 trunk rounding bounds bf16
    tol = dict(atol=1e-5, rtol=1e-4) if not bf16 else dict(atol=5e-3, rtol=2e-2)
    np.testing.assert_allclose(mu_p.numpy(), np.asarray(mu_j), **tol)
    np.testing.assert_allclose(var_p.numpy(), np.asarray(var_j), **tol)
    # the SCM runs in fp32 in both packages: tight on the same mu
    mu = rng.randn(4, 32).astype(np.float32)
    zj = jax.jit(lambda v, m: jmodel.apply(v, m, method=JaxUNet.causalize))(variables, mu)
    with torch.no_grad():
        zp = pmodel.causalize(torch.from_numpy(mu))
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5, rtol=1e-4)
    # encode_and_causalize with injected noise: z = z_post + sqrt(1e-3) * noise
    noise = rng.randn(3, 32).astype(np.float32)
    with torch.no_grad():
        _, _, z_post, z = pmodel.encode_and_causalize(torch.from_numpy(x),
                                                      noise=torch.from_numpy(noise))
    np.testing.assert_allclose(z.numpy(), z_post.numpy() + np.sqrt(np.float32(1e-3)) * noise,
                               atol=1e-6)
