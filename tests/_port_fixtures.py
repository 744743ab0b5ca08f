"""Shared helpers for the port's tests (``tests/test_torch_*.py``).

The same weights go into both packages: a flax parameter tree shaped by
``jax.eval_shape`` (nothing is computed at init), filled from a numpy seed,
and carried into the port with ``state_dict_from_flax``. Every parameter is
filled, the zero-initialised output convs and attention projections
included, so that each block's output reaches eps.
"""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none.

    Decided here, inside the fixture, so that every test collects the same
    way on every worker."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return "cuda"


def tiny_kwargs(**overrides):
    """28px, 32 channels, 1 res block, 2 heads, attention at ds=2 (T=196)."""
    base = dict(
        name="tiny", dataset="morphomnist", image_size=28, in_channels=1,
        num_channels=32, num_res_blocks=1, num_heads=2, n_vars=2, rep_dim=32,
        attention_resolutions="14", class_cond=True, rep_cond=True,
        causal_modeling=True, masking=True, diffusion_steps=100,
        eval_timestep_respacing="10", abduction_t=9,
    )
    base.update(overrides)
    return base


def configs(use_bf16: bool, **overrides):
    """(JAX Config, port Config) for the same model; the JAX side runs its
    einsum attention path (use_pallas=False), which has the same math."""
    from causaldiffae_tpu.config import Config as JaxConfig
    from causaldiffae_torch.config import Config as PortConfig

    kw = tiny_kwargs(use_bf16=use_bf16, **overrides)
    return JaxConfig(use_pallas=False, **kw), PortConfig(use_kernels=True, **kw)


def _fill(tree, rng, std, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, std, path + (k,))
            continue
        shape = tuple(v.shape)
        if "batch_stats" in path and k == "var":
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif "batch_stats" in path:
            out[k] = (0.1 * rng.randn(*shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + std * rng.randn(*shape)).astype(np.float32)
        else:
            out[k] = (std * rng.randn(*shape)).astype(np.float32)
    return out


def flax_variables(jax_cfg, seed: int = 0, std: float = 0.05):
    """Seeded numpy variables for ``create_model(jax_cfg)``, shaped by eval_shape."""
    import jax
    import jax.numpy as jnp

    from causaldiffae_tpu.config import create_model

    model = create_model(jax_cfg)
    s = jax_cfg.image_size
    x = jnp.zeros((1, s, s, jax_cfg.in_channels), jnp.float32)
    t = jnp.zeros((1,), jnp.int32)
    y = jnp.zeros((1,), jnp.int32) if jax_cfg.class_cond else None
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "reparam": key, "cfmask": key, "dropout": key}
    shapes = jax.eval_shape(lambda: model.init(rngs, x, t, y=y, x_start=x))
    shapes = jax.tree_util.tree_map(lambda a: a, dict(shapes))
    tree = {k: _plain_dict(v) for k, v in shapes.items()}
    return model, _fill(tree, np.random.RandomState(seed), std)


def _plain_dict(tree):
    if hasattr(tree, "items"):
        return {k: _plain_dict(v) for k, v in tree.items()}
    return tree


def port_model(port_cfg, variables):
    """The port's CausalUNet on the CPU with ``variables`` loaded strictly."""
    from causaldiffae_torch.config import create_model
    from causaldiffae_torch.utils.weights import state_dict_from_flax

    model = create_model(port_cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(port_cfg, variables), strict=True)
    return model
