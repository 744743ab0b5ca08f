"""The port on CausalCircuit- and Pendulum-like models against the JAX package.

A tiny circuit-like config (32x32x3, 4 variables, no classes, the circuit's
causal graph, 2000 diffusion steps respaced to 10, attention at two levels)
and a pendulum-like one (32x32x4, the pendulum's graph, attention only in
the middle block), with the same flax weights carried into the port by
``utils/weights.py``:

- ``denoise``;
- ``training_losses`` through the training forward, with the noise, the
  reparameterization draw and the keep-mask the JAX forward makes from its
  rngs handed to the port;
- the counterfactual function (``where='auto'``) with the JAX function's own
  draws handed over;
- a circuit_conditional-like model's do() on the context, as the serve CLI
  answers it (``serve.context_counterfactual_fn``), against the body of the
  conditional mode of ``scripts/counterfactual_test.py`` built from the JAX
  package's ``q_sample``, ``resolve_sampler`` and ``denoise``, with its
  abduction noise handed over;
- which intervention point ``where='auto'`` picks for each variable of the
  two 4-variable graphs (and for a model without a graph).

Tolerances: fp32 atol 2e-4, rtol 1e-3 (the ROADMAP's); ten chained UNet
calls of the counterfactual, atol and rtol 1e-3, as
``tests/test_torch_serving.py`` holds the morphomnist chain.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import (F32_TOL, configs, flax_variables, one_torch_thread,  # noqa: F401
                            port_model)
from causaldiffae_tpu.config import create_diffusion as jax_create_diffusion
from causaldiffae_tpu.diffusion import create_diffusion as jax_respaced
from causaldiffae_tpu.evals import resolve_sampler as jax_resolve_sampler
from causaldiffae_tpu.evals.counterfactual import make_counterfactual_fn as jax_make_cf
from causaldiffae_tpu.models.unet import CausalUNet as JaxUNet
from causaldiffae_torch.config import create_diffusion as port_create_diffusion
from causaldiffae_torch.diffusion import create_diffusion as port_respaced
from causaldiffae_torch import serve
from causaldiffae_torch.evals.counterfactual import make_counterfactual_fn
from causaldiffae_torch.training.train_step import compute_losses

CIRCUIT = dict(dataset="circuit", image_size=32, in_channels=3, n_vars=4, rep_dim=32,
               class_cond=False, attention_resolutions="8,4", diffusion_steps=2000,
               eval_timestep_respacing="10", abduction_t=9)
# attention_resolutions "6" is ds 5, no level of the UNet: only the middle block attends
PENDULUM = dict(CIRCUIT, dataset="pendulum", in_channels=4, attention_resolutions="6")
CONDITIONAL = dict(CIRCUIT, rep_cond=False, context_cond=True, causal_modeling=False,
                   masking=False)
B = 2
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _models(overrides):
    jax_cfg, port_cfg = configs(use_bf16=False, **overrides)
    jmodel, variables = flax_variables(jax_cfg, seed=21)
    return jax_cfg, port_cfg, jmodel, variables, port_model(port_cfg, variables)


@pytest.fixture(scope="module")
def circuit():
    return _models(CIRCUIT)


def _images(cfg, seed):
    rng = np.random.RandomState(seed)
    return np.clip(rng.randn(B, cfg.image_size, cfg.image_size, cfg.in_channels) * 0.5,
                   -1, 1).astype(np.float32)


@pytest.mark.parametrize("overrides", [CIRCUIT, PENDULUM], ids=["circuit", "pendulum"])
def test_denoise_matches_jax(overrides):
    jax_cfg, port_cfg, jmodel, variables, pmodel = _models(overrides)
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in pmodel.modules())
    assert n_attn == (7 if overrides is CIRCUIT else 1)
    x = _images(port_cfg, 1)
    t = np.array([5, 1500])
    z = np.random.RandomState(2).randn(B, port_cfg.rep_dim).astype(np.float32)
    want = jax.jit(lambda v, x, t, z: jmodel.apply(v, x, t, z=z, method=JaxUNet.denoise))(
        variables, x, jnp.asarray(t, jnp.int32), z)
    with torch.no_grad():
        got = pmodel.denoise(torch.from_numpy(x), torch.from_numpy(t), z=torch.from_numpy(z))
    assert got.shape == x.shape and float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_training_losses_match_jax(circuit):
    """The JAX loss_fn's forward (train-mode BatchNorm, its own rngs) against
    the port's ``compute_losses`` fed the same noise and the same draws."""
    jax_cfg, port_cfg, jmodel, variables, _ = circuit
    pmodel = port_model(port_cfg, variables).train()  # its BatchNorm statistics move
    x0 = (np.random.RandomState(3).randint(0, 256, (B, 32, 32, 3)) / 127.5 - 1).astype(np.float32)
    noise = np.random.RandomState(4).randn(*x0.shape).astype(np.float32)
    c = np.random.RandomState(5).rand(B, 4).astype(np.float32)
    t = np.array([3, 1999])
    r_rep, r_mask = jax.random.split(jax.random.PRNGKey(6))
    jd = jax_create_diffusion(jax_cfg)

    def jax_terms(variables, x0, t, noise, c):
        def forward(x_t, t_model):
            (eps, aux), _ = jmodel.apply(variables, x_t, t_model, x_start=x0, train=True,
                                         rngs={"reparam": r_rep, "cfmask": r_mask},
                                         mutable=["batch_stats"])
            return eps, aux
        return jd.training_losses(forward, x0, t, jax.random.PRNGKey(0), c=c, rep_cond=True,
                                  causal_modeling=True, kl_weight=0.3, noise=noise)

    want = jax.jit(jax_terms)(variables, x0, jnp.asarray(t, jnp.int32), noise, c)
    # the draws the forward makes from its rngs, in the root module's scope
    k_rep, k_mask = jmodel.apply({}, method=lambda m: (m.make_rng("reparam"),
                                                       m.make_rng("cfmask")),
                                 rngs={"reparam": r_rep, "cfmask": r_mask})
    rep_noise = np.array(jax.random.normal(k_rep, (B, port_cfg.rep_dim)), np.float32)
    keep = np.array(jax.random.bernoulli(k_mask, 1.0 - port_cfg.drop_prob, (B,)), np.float32)
    got = compute_losses(port_cfg, pmodel, port_create_diffusion(port_cfg),
                         torch.from_numpy(x0), {"c": torch.from_numpy(c)}, torch.from_numpy(t),
                         0.3, noise=torch.from_numpy(noise),
                         rep_noise=torch.from_numpy(rep_noise), keep=torch.from_numpy(keep))
    assert sorted(got) == sorted(want) and {"mse", "kld_rep"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **F32_TOL)


def test_counterfactual_matches_jax(circuit):
    """do(red) on the circuit graph: 'auto' picks 'post' on both sides; DDIM
    over the 10-step respacing of 2000 steps, abduction at t=9."""
    jax_cfg, port_cfg, jmodel, variables, pmodel = circuit
    x = _images(port_cfg, 7)
    key = jax.random.PRNGKey(8)
    jfn = jax.jit(jax_make_cf(jax_cfg, jmodel, jax_respaced(steps=2000, timestep_respacing="10"),
                              intervene_var=3, where="auto"))
    want = np.asarray(jfn(variables, jnp.asarray(x), {}, 0.7, key))
    r_noise, r_rep, _ = jax.random.split(key, 3)  # the JAX function's own draws
    fn = make_counterfactual_fn(port_cfg, pmodel, port_respaced(steps=2000,
                                timestep_respacing="10"), intervene_var=3, where="auto")
    got = fn(torch.from_numpy(x), {}, 0.7,
             abduction_noise=torch.from_numpy(np.array(jax.random.normal(r_noise, x.shape))),
             rep_noise=torch.from_numpy(np.array(jax.random.normal(r_rep, (B, port_cfg.rep_dim)))))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("sampler,sample_steps", [("ddim", None), ("dpm++", 4)])
def test_context_counterfactual_matches_jax(sampler, sample_steps):
    """do(blue) on a context model: the edited c, abduction at t=9, then the
    chain, against the JAX conditional mode's ``gen`` on the same weights."""
    jax_cfg, port_cfg, jmodel, variables, pmodel = _models(CONDITIONAL)
    x = _images(port_cfg, 10)
    c = np.random.RandomState(11).rand(B, 4).astype(np.float32)
    c_edit = c.copy()
    c_edit[:, 2] = 0.7
    rng = jax.random.PRNGKey(12)
    jd = jax_create_diffusion(jax_cfg, eval_mode=True)
    loop = jax_resolve_sampler(jax_cfg.eval_use_ddim, sampler, sample_steps)

    def gen(variables, c_edit, x, rng):  # scripts/counterfactual_test.py:341-350
        def model_fn(xx, tt):
            return jmodel.apply(variables, xx, tt, y=None, c=c_edit, train=False,
                                method=JaxUNet.denoise)
        noise = jax.random.normal(jax.random.fold_in(rng, 0), x.shape)
        t = jnp.full((x.shape[0],), jax_cfg.abduction_t, dtype=jnp.int32)
        x_t = jd.q_sample(x, t, noise)
        return loop(jd, model_fn, x_t, jax.random.fold_in(rng, 1),
                    clip_denoised=jax_cfg.clip_denoised)

    want = np.asarray(jax.jit(gen)(variables, jnp.asarray(c_edit), jnp.asarray(x), rng))
    noise = np.array(jax.random.normal(jax.random.fold_in(rng, 0), x.shape))
    fn = serve.context_counterfactual_fn(port_cfg, pmodel,
                                         port_create_diffusion(port_cfg, eval_mode=True),
                                         intervene_var=2, sampler=sampler,
                                         sample_steps=sample_steps)
    got = fn(torch.from_numpy(x), {"c": torch.from_numpy(c)}, 0.7,
             abduction_noise=torch.from_numpy(noise))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dataset,points", [
    ("circuit", ["pre", "post", "post", "post"]),   # arm -> {blue, green, red}; blue, green -> red
    ("pendulum", ["pre", "pre", "post", "post"]),   # {angle, light} -> {shadow_len, shadow_pos}
    ("none", ["pre"] * 4),                          # no causal graph: every variable a root
])
def test_where_auto_follows_the_4_variable_graphs(dataset, points):
    from causaldiffae_torch.config import Config, create_model
    from causaldiffae_torch.utils.weights import fill_normal_

    cfg = Config(**dict(CIRCUIT, dataset="circuit" if dataset == "none" else dataset,
                        rep_cond=True, causal_modeling=dataset != "none", num_channels=32, num_res_blocks=1,
                        num_heads=2, eval_timestep_respacing="2", abduction_t=1))
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    fill_normal_(model, torch.Generator().manual_seed(1), std=0.05)
    diffusion = port_respaced(steps=2000, timestep_respacing="2")
    x = torch.from_numpy(_images(cfg, 9))
    draws = dict(abduction_noise=torch.randn(x.shape, generator=torch.Generator().manual_seed(2)),
                 rep_noise=torch.randn(B, cfg.rep_dim, generator=torch.Generator().manual_seed(3)))
    for var, point in enumerate(points):
        run = lambda where: make_counterfactual_fn(cfg, model, diffusion, intervene_var=var,
                                                   where=where)(x, {}, 1.5, **draws)
        auto = run("auto")
        assert torch.equal(auto, run(point)), (dataset, var)
        if cfg.causal_modeling:
            other = "post" if point == "pre" else "pre"
            assert not torch.equal(auto, run(other)), (dataset, var)
