"""The port's VLB sweep (``diffusion.calc_bpd_loop``) against the JAX package's.

A tiny CausalUNet in fp32 (T = 6, cosine schedule), the same weights in both
packages and the same z; the test rebuilds the JAX function's per-t key
splits to get its noise and hands that noise to the port. ``total_bpd``,
``prior_bpd`` and the ascending-t ``[N, T]`` terms ``vb``, ``mse`` and
``xstart_mse`` agree within fp32 tolerances (atol 2e-4, rtol 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import configs, flax_variables, one_torch_thread, port_model  # noqa: F401
from causaldiffae_tpu.config import create_diffusion as jax_create_diffusion
from causaldiffae_tpu.diffusion.sampling import calc_bpd_loop as jax_calc_bpd_loop
from causaldiffae_tpu.models.unet import CausalUNet as JaxUNet
from causaldiffae_torch.config import create_diffusion
from causaldiffae_torch.diffusion import calc_bpd_loop

F32_TOL = dict(atol=2e-4, rtol=1e-3)
T = 6
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def sweep():
    """Both sweeps on the same batch, weights and z; the JAX noise rebuilt."""
    jcfg, pcfg = configs(False, diffusion_steps=T, noise_schedule="cosine")
    jmodel, variables = flax_variables(jcfg, seed=3)
    pmodel = port_model(pcfg, variables)
    rng = np.random.RandomState(5)
    x = (np.round(rng.rand(3, 28, 28, 1) * 255) / 255).astype(np.float32)
    y = np.array([1, 4, 7])
    z = rng.randn(3, pcfg.rep_dim).astype(np.float32)
    key = jax.random.PRNGKey(9)

    @jax.jit
    def run(variables, x, y, z, key):
        model_fn = lambda xx, tt: jmodel.apply(variables, xx, tt, y=y, z=z, train=False,
                                               method=JaxUNet.denoise)
        return jax_calc_bpd_loop(jax_create_diffusion(jcfg), model_fn, x, key)

    want = jax.device_get(run(variables, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), key))
    noise = []
    for _ in range(T):  # calc_bpd_loop's scan: key, sub = split(key) per t
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, x.shape, jnp.float32)))
    diffusion = create_diffusion(pcfg)
    yt, zt = torch.from_numpy(y), torch.from_numpy(z)
    model_fn = lambda xx, tt: pmodel.denoise(xx, tt, y=yt, z=zt)
    with torch.inference_mode():
        got = calc_bpd_loop(diffusion, model_fn, torch.from_numpy(x),
                            noise=torch.from_numpy(np.stack(noise)))
        drawn = calc_bpd_loop(diffusion, model_fn, torch.from_numpy(x),
                              torch.Generator().manual_seed(0))
    return want, got, drawn


@pytest.mark.parametrize("key", ["total_bpd", "prior_bpd", "vb", "mse", "xstart_mse"])
def test_calc_bpd_loop_matches_jax(sweep, key):
    want, got, _ = sweep
    assert tuple(got[key].shape) == np.shape(want[key])
    np.testing.assert_allclose(got[key].numpy(), want[key], **F32_TOL)


def test_calc_bpd_loop_draws_its_own_noise(sweep):
    """Without ``noise`` the sweep draws from the generator: the same shapes,
    finite, and total = sum of the terms + prior (ascending t: column 0 is
    the decoder NLL at t = 0)."""
    _, got, drawn = sweep
    for k in got:
        assert drawn[k].shape == got[k].shape and bool(torch.isfinite(drawn[k]).all())
    torch.testing.assert_close(drawn["total_bpd"], drawn["vb"].sum(1) + drawn["prior_bpd"])
    assert drawn["vb"].shape == (3, T)
    assert not torch.equal(drawn["mse"], got["mse"])
