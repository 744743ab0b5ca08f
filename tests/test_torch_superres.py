"""The port's ``SuperResUNet``, ``create_sr_model`` and ``feature_vectors``
against the JAX package's (``causaldiffae_tpu/models/unet.py:280-311``,
``config.py:203-223``).

The same seeded flax variables go into both packages (the SR model's UNet
under flax's ``unet`` subtree, carried by ``utils.weights.state_dict_from_flax``
with the UNet's config). fp32 tolerances: atol 2e-4, rtol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import _fill, _plain_dict, configs, flax_variables, one_torch_thread  # noqa: F401
from _port_fixtures import port_model

F32_TOL = dict(atol=2e-4, rtol=1e-3)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _sr_pair(large, small):
    """(JAX SR model, its variables, the port's SR model with them loaded)."""
    from causaldiffae_tpu.config import create_sr_model as jax_create_sr
    from causaldiffae_torch.config import create_sr_model
    from causaldiffae_torch.utils.weights import state_dict_from_flax

    jax_cfg, port_cfg = configs(use_bf16=False, in_channels=3, rep_cond=False,
                                causal_modeling=False, masking=False, class_cond=True,
                                attention_resolutions="16")
    jmodel = jax_create_sr(jax_cfg, large_size=large, small_size=small)
    x = jnp.zeros((1, large, large, 3))
    low = jnp.zeros((1, small, small, 3))
    t = jnp.zeros((1,), jnp.int32)
    y = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, x, t,
                                                low_res=low, y=y))
    variables = _fill({k: _plain_dict(v) for k, v in dict(shapes).items()},
                      np.random.RandomState(3), 0.05)
    pmodel = create_sr_model(port_cfg, large_size=large, small_size=small, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(port_cfg.replace(image_size=large), variables),
                           strict=True)
    return jmodel, variables, pmodel


@pytest.mark.parametrize("small", [16, 15], ids=["even", "odd"])
def test_superres_eps_matches_jax(small):
    """eps of the SR model at 32 from a 16 and an odd 15 low-res image."""
    large = 32
    jmodel, variables, pmodel = _sr_pair(large, small)
    rng = np.random.RandomState(4)
    x = rng.randn(2, large, large, 3).astype(np.float32)
    low = rng.uniform(-1, 1, (2, small, small, 3)).astype(np.float32)
    t = np.array([3, 70])
    y = np.array([1, 6])
    want, _ = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                           low_res=jnp.asarray(low), y=jnp.asarray(y, jnp.int32))
    with torch.no_grad():
        got, aux = pmodel(torch.from_numpy(x), torch.from_numpy(t), low_res=torch.from_numpy(low),
                          y=torch.from_numpy(y))
    assert got.shape == (2, large, large, 3) and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("small", [16, 15, 7], ids=["even", "odd", "odd_x4"])
def test_bilinear_upsampling_matches_jax_resize(small):
    """``F.interpolate`` bilinear (half-pixel centres) equals
    ``jax.image.resize(..., "bilinear")`` when it upsamples, borders included."""
    low = np.random.RandomState(5).randn(2, small, small, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(low), (2, 32, 32, 3), method="bilinear")
    got = torch.nn.functional.interpolate(torch.from_numpy(low).permute(0, 3, 1, 2),
                                          size=(32, 32), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_feature_vectors_match_jax():
    """Every activation of ``feature_vectors``: as many as the JAX structure
    has, each of its shape (NHWC) and value."""
    jax_cfg, port_cfg = configs(use_bf16=False)
    jmodel, variables = flax_variables(jax_cfg)
    pmodel = port_model(port_cfg, variables)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 28, 28, 1).astype(np.float32)
    t = np.array([5, 60])
    y = np.array([2, 9])
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                        y=jnp.asarray(y, jnp.int32), method=jmodel.feature_vectors)
    with torch.no_grad():
        got = pmodel.feature_vectors(torch.from_numpy(x), torch.from_numpy(t),
                                     y=torch.from_numpy(y))
    assert set(got) == set(want) == {"down", "middle", "up"}
    assert len(got["down"]) == len(want["down"]) and len(got["up"]) == len(want["up"])
    pairs = list(zip(got["down"], want["down"])) + [(got["middle"], want["middle"])] + \
        list(zip(got["up"], want["up"]))
    for i, (g, w) in enumerate(pairs):
        assert tuple(g.shape) == tuple(w.shape), i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"activation {i}",
                                   **F32_TOL)
