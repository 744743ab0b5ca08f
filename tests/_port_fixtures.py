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


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module: at these tiny sizes the
    threads cost more than they give, the more so while the suite's workers
    share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # the context is the dataset's label vector, which sizes c_dense1
    c = jnp.zeros((1, len(jax_cfg.label_scale)), jnp.float32) if jax_cfg.context_cond else None
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "reparam": key, "cfmask": key, "dropout": key}
    shapes = jax.eval_shape(lambda: model.init(rngs, x, t, y=y, c=c, x_start=x))
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


# --------------------------------------------------------------------- #
# One train step of each package on the same variables, batch and draws
# (tests/test_torch_train_step*.py).
# --------------------------------------------------------------------- #
STEP_B = 4
STEP_LR = 1e-4
STEP0 = 5  # kl_weight = 5/9 > 0, so the representation KL has a gradient
F32_TOL = dict(atol=2e-4, rtol=1e-3)
PARAM_ATOL = 2.5e-4  # > 2 lr: a first AdamW step moves a parameter by about +-lr


def make_batch(seed, nan=False):
    """A batch on the 8-bit grid, NHWC, as the trainer's data; optionally with a NaN."""
    rng = np.random.RandomState(seed)
    image = np.round(rng.rand(STEP_B, 28, 28, 1) * 255).astype(np.float32) / 255
    if nan:
        image[1, 3, 4, 0] = np.nan
    return {"image": image, "y": (np.arange(STEP_B) % 10).astype(np.int32),
            "c": rng.randn(STEP_B, 2).astype(np.float32)}


def _capture():
    """An optax stage that passes the gradients on and keeps them as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


class StepPair:
    """The JAX ``make_train_step`` and the port's on the same variables.

    ``step(batch)`` rebuilds the draws the JAX step makes from its rng --
    ``fold_in(base_rng, step)`` split into ``rng_t`` and ``rng_loss``; t from
    ``sample_timesteps(.., rng_t)``; per microbatch ``split(rng_loss, 4)``
    (after ``fold_in(rng_loss, i)`` when there are several) into the noise,
    reparameterization, keep-mask and dropout keys, the middle two replayed
    in the model's root scope with ``make_rng`` -- hands them to the port,
    and runs both steps. The JAX optimizer is ``chain(capture, adamw)``, so
    its state keeps the step's gradients.
    """

    def __init__(self, use_bf16, **overrides):
        import jax
        import jax.numpy as jnp
        import optax

        from causaldiffae_tpu.config import create_diffusion as jax_create_diffusion
        from causaldiffae_tpu.training.state import TrainState, make_optimizer
        from causaldiffae_tpu.training.train_step import make_train_step as jax_make_train_step
        from causaldiffae_torch.config import create_diffusion
        from causaldiffae_torch.training import create_train_state, make_train_step

        self.jcfg, self.pcfg = configs(use_bf16, batch_size=STEP_B, lr=STEP_LR,
                                       kl_anneal_steps=10, **overrides)
        self.jmodel, self.variables = flax_variables(self.jcfg, seed=11)
        tx = optax.chain(_capture(), make_optimizer(self.jcfg))
        params = jax.tree_util.tree_map(jnp.asarray, self.variables["params"])
        self.jstate = TrainState(
            step=jnp.int32(STEP0), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray, self.variables["batch_stats"]),
            opt_state=tx.init(params), ema_params={"0.9999": params}, sampler_state=None,
            base_rng=jax.random.PRNGKey(7))
        self.num_timesteps = jax_create_diffusion(self.jcfg).num_timesteps
        self.jstep = jax.jit(jax_make_train_step(self.jcfg, self.jmodel,
                                                 jax_create_diffusion(self.jcfg), tx))
        self.jdraws = jax.jit(self._jax_draws)
        self.pmodel = port_model(self.pcfg, self.variables)
        self.pstate = create_train_state(self.pcfg, self.pmodel)
        self.pstate.step = STEP0
        self.pstep = make_train_step(self.pcfg, self.pmodel, create_diffusion(self.pcfg),
                                     self.pstate.optimizer)

    @staticmethod
    def _jax_batch(batch):
        import jax.numpy as jnp

        return {k: jnp.asarray(v) for k, v in batch.items()}

    def _jax_draws(self, base_rng, step, sampler_state):
        import jax
        import jax.numpy as jnp

        from causaldiffae_tpu.training.samplers import sample_timesteps

        cfg = self.jcfg
        rng_t, rng_loss = jax.random.split(jax.random.fold_in(base_rng, step))
        t, _ = sample_timesteps(sampler_state, self.num_timesteps, STEP_B, rng_t)
        micro = cfg.microbatch if cfg.microbatch > 0 else STEP_B
        n_micro = max(STEP_B // micro, 1)
        noise, rep, keep = [], [], []
        for i in range(n_micro):
            r = rng_loss if n_micro == 1 else jax.random.fold_in(rng_loss, i)
            r_noise, r_rep, r_mask, _ = jax.random.split(r, 4)
            k_rep, k_mask = self.jmodel.apply(
                {}, method=lambda m: (m.make_rng("reparam"), m.make_rng("cfmask")),
                rngs={"reparam": r_rep, "cfmask": r_mask})
            noise.append(jax.random.normal(r_noise, (micro, 28, 28, 1)))
            rep.append(jax.random.normal(k_rep, (micro, cfg.rep_dim)))
            keep.append(jax.random.bernoulli(k_mask, 1.0 - cfg.drop_prob, (micro,)))
        return t, jnp.concatenate(noise), jnp.concatenate(rep), jnp.concatenate(keep)

    def draws(self):
        import torch

        js = self.jstate
        t, noise, rep, keep = self.jdraws(js.base_rng, js.step, js.sampler_state)
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
        return {"t": torch.from_numpy(np.asarray(t, np.int64)), "noise": f32(noise),
                "rep_noise": f32(rep), "keep": f32(keep)}

    def step(self, batch):
        """Both steps on ``batch``; returns their metrics as floats (jax, port)."""
        import torch

        draws = self.draws()
        self.jstate, jm = self.jstep(self.jstate, self._jax_batch(batch))
        pm = self.pstep(self.pstate, {k: torch.from_numpy(v.astype(np.int64) if k == "y" else v)
                                      for k, v in batch.items()}, draws=draws)
        return {k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in pm.items()}

    def port_sd(self, tree):
        """A flax tree (params, gradients or EMA) under the port's keys, numpy."""
        from causaldiffae_torch.utils.weights import state_dict_from_flax

        sd = state_dict_from_flax(self.pcfg, {"params": tree,
                                              "batch_stats": self.jstate.batch_stats})
        return {k: v.numpy() for k, v in sd.items()}

    def jax_grads(self):
        return self.port_sd(self.jstate.opt_state[0])


# --------------------------------------------------------------------- #
# Serving artifacts (tests/test_torch_export.py, test_torch_serve_artifact.py)
# --------------------------------------------------------------------- #
def make_checkpoint(path, **overrides):
    """A tiny model with every weight filled, saved as the train CLI saves
    (respaced to 4 steps, abduction at t=3)."""
    import torch

    from causaldiffae_torch.config import Config, create_model
    from causaldiffae_torch.training import CheckpointManager
    from causaldiffae_torch.training.state import create_train_state
    from causaldiffae_torch.utils.weights import fill_normal_

    cfg = Config(**tiny_kwargs(eval_timestep_respacing="4", abduction_t=3, **overrides))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = create_model(cfg, device="cpu")
    fill_normal_(model, torch.Generator().manual_seed(0), std=0.05)
    CheckpointManager(str(path), config=cfg).save(1, create_train_state(cfg, model))
    return str(path)


def export(ckpt, out, *argv):
    """``export_serving``'s main on the CPU; returns the manifest."""
    from causaldiffae_torch import export_serving

    return export_serving.main(["--ckpt_dir", ckpt, "--out", str(out), "--device", "cpu",
                                *argv])
