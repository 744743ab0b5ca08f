"""The port's training pieces against the JAX package's.

- ``diffusion/losses.py``, ``vb_terms_bpd``/``prior_bpd``,
  ``representation_loss`` (with a mask, an all-dropped mask, no mask) and
  ``training_losses`` (MSE with the representation KL, learned sigma, KL),
  values and gradients, with the same noise;
- the encoder's train-mode BatchNorm against flax with
  ``mutable=["batch_stats"]``: outputs and the new running statistics, and a
  check that torch's own (unbiased) running-variance update would differ;
- the samplers (duplicate-t pushes, weights after warm-up), the KL anneal
  and the optimizer (AdamW with decay and the LR anneal, and a skipped
  step) against optax;
- the synthetic MorphoMNIST pool and its batch iterator, bit for bit;
- the train CLI on the CPU.
(The whole train step against ``make_train_step``: ``test_torch_train_step.py``.)

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 atol 2e-4, rtol 1e-3; the bf16 check states its own bound.
"""

import csv
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _port_fixtures import configs, flax_variables, port_model
from causaldiffae_tpu.config import create_diffusion as jax_create_diffusion
from causaldiffae_tpu.diffusion import losses as jl
from causaldiffae_tpu.models.unet import CausalUNet as JaxUNet
from causaldiffae_tpu.training import samplers as js
from causaldiffae_tpu.training.state import kl_weight_for_step as jax_kl_weight
from causaldiffae_tpu.training.state import make_optimizer as jax_make_optimizer
from causaldiffae_torch.config import Config
from causaldiffae_torch.config import create_diffusion as port_create_diffusion
from causaldiffae_torch.diffusion import losses as tl
from causaldiffae_torch.training import samplers as ts
from causaldiffae_torch.training.state import anneal_lr_, kl_weight_for_step, make_optimizer

F32_TOL = dict(atol=2e-4, rtol=1e-3)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or F32_TOL))


def _assert_bf16_close(got, want):
    diff = got - want
    rms = lambda a: float(np.sqrt(np.mean(a * a)))
    assert rms(diff) <= 5e-2 * rms(want), (rms(diff), rms(want))
    assert np.abs(diff).max() <= 8e-2 * np.abs(want).max(), (np.abs(diff).max(),
                                                              np.abs(want).max())


def _diffusions(**kw):
    return jax_create_diffusion(Config(**kw)), port_create_diffusion(Config(**kw))


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    m1, lv1, m2, lv2 = rng.randn(4, 3, 5).astype(np.float32)
    T = torch.from_numpy
    _close(tl.normal_kl(T(m1), T(lv1), T(m2), T(lv2)), jl.normal_kl(m1, lv1, m2, lv2))
    _close(tl.normal_kl(T(m1), T(lv1), 0.0, 0.0), jl.normal_kl(m1, lv1, 0.0, 0.0))
    qv, pv = rng.uniform(0.3, 2.0, (2, 3, 5)).astype(np.float32)
    _close(tl.kl_normal(T(m1), T(qv), T(m2), T(pv)), jl.kl_normal(m1, qv, m2, pv))
    _close(tl.approx_standard_normal_cdf(T(3 * m1)), jl.approx_standard_normal_cdf(3 * m1))
    # edges included; means within ~1.3 std of x: far in the tails the
    # formula's cdf difference cancels to 0 or an ulp in either framework
    x = (rng.randint(0, 256, (2, 6, 6, 1)) / 127.5 - 1.0).astype(np.float32)
    means = (x + 0.02 * rng.randn(*x.shape)).astype(np.float32)
    log_scales = rng.uniform(-3.0, -1.0, x.shape).astype(np.float32)
    _close(tl.discretized_gaussian_log_likelihood(T(x), means=T(means), log_scales=T(log_scales)),
           jl.discretized_gaussian_log_likelihood(x, means=means, log_scales=log_scales))
    _close(tl.mean_flat(T(x)), jl.mean_flat(x))


@pytest.mark.parametrize("learn_sigma", [False, True], ids=["fixed", "learned"])
def test_vb_terms_and_prior_bpd_match(learn_sigma):
    jd, pd = _diffusions(diffusion_steps=100, learn_sigma=learn_sigma)
    rng = np.random.RandomState(1)
    x0 = (rng.randint(0, 256, (4, 8, 8, 1)) / 127.5 - 1.0).astype(np.float32)
    noise = rng.randn(4, 8, 8, 1).astype(np.float32)
    t = np.array([0, 1, 50, 99])
    xt = np.array(jd.q_sample(jnp.asarray(x0), jnp.asarray(t, jnp.int32), jnp.asarray(noise)))
    # an eps close to the true one keeps the t = 0 decoder term well
    # conditioned (far in the tails its cdf difference cancels to 0 or an ulp)
    out = (noise + 0.01 * rng.randn(*noise.shape)).astype(np.float32)
    if learn_sigma:
        out = np.concatenate([out, rng.uniform(-1, 1, noise.shape).astype(np.float32)], -1)
    want = jd.vb_terms_bpd(lambda *_: jnp.asarray(out), jnp.asarray(x0), jnp.asarray(xt),
                           jnp.asarray(t, jnp.int32), clip_denoised=False)
    got = pd.vb_terms_bpd(lambda *_: torch.from_numpy(out), torch.from_numpy(x0),
                          torch.from_numpy(xt), torch.from_numpy(t), clip_denoised=False)
    _close(got["output"], want["output"])
    _close(got["pred_xstart"], want["pred_xstart"])
    _close(pd.prior_bpd(torch.from_numpy(x0)), jd.prior_bpd(jnp.asarray(x0)))


@pytest.mark.parametrize("mask", ["mask", "all_dropped", "none"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "plain"])
def test_representation_loss_matches(mask, causal):
    jd, pd = _diffusions(diffusion_steps=100)
    rng = np.random.RandomState(2)
    mu, z_post = rng.randn(2, 4, 8).astype(np.float32)
    var = rng.uniform(0.2, 2.0, (4, 8)).astype(np.float32)
    c = rng.randn(4, 2).astype(np.float32)
    m = {"mask": np.array([1, 0, 1, 1], np.float32), "all_dropped": np.zeros(4, np.float32),
         "none": None}[mask]
    want = jd.representation_loss(mu, var, z_post, causal, m, c)
    got = pd.representation_loss(*(torch.from_numpy(a) for a in (mu, var, z_post)), causal,
                                 None if m is None else torch.from_numpy(m), torch.from_numpy(c))
    assert got.shape == np.shape(want)
    _close(got, want)
    if mask == "all_dropped":
        assert float(got) == 0.0


def _forward_fns(out_channels, aux_np):
    """A deterministic 'model' of one weight w in both packages:
    eps = x_t * w[0] + 1e-3 t, and a tanh variance head when it has two
    output channels; aux from fixed arrays."""
    def jax_fn(w):
        def f(x_t, t_model):
            out = x_t * w[0] + 1e-3 * t_model.astype(jnp.float32)[:, None, None, None]
            if out_channels == 2:
                out = jnp.concatenate([out, jnp.tanh(x_t * w[1])], axis=-1)
            return out, {k: None if v is None else jnp.asarray(v) for k, v in aux_np.items()}
        return f

    def torch_fn(w):
        def f(x_t, t_model):
            out = x_t * w[0] + 1e-3 * t_model.float()[:, None, None, None]
            if out_channels == 2:
                out = torch.cat([out, torch.tanh(x_t * w[1])], dim=-1)
            return out, {k: None if v is None else torch.from_numpy(v) for k, v in aux_np.items()}
        return f

    return jax_fn, torch_fn


@pytest.mark.parametrize("kind", ["mse_rep", "learned_sigma", "kl"])
def test_training_losses_match_values_and_gradients(kind):
    kw = dict(diffusion_steps=100, learn_sigma=kind == "learned_sigma", use_kl=kind == "kl")
    jd, pd = _diffusions(**kw)
    rng = np.random.RandomState(3)
    B = 4
    x0 = (rng.randint(0, 256, (B, 6, 6, 1)) / 127.5 - 1.0).astype(np.float32)
    noise = rng.randn(*x0.shape).astype(np.float32)
    t = np.array([0, 3, 40, 99])
    w = (1.0 + 0.1 * rng.randn(2, 6, 6, 1)).astype(np.float32)
    c = rng.randn(B, 2).astype(np.float32)
    aux = {"mu": rng.randn(B, 8).astype(np.float32),
           "var": rng.uniform(0.2, 2.0, (B, 8)).astype(np.float32),
           "z_post": rng.randn(B, 8).astype(np.float32),
           "mask": np.array([1, 1, 0, 1], np.float32)}
    jax_fn, torch_fn = _forward_fns(2 if kind == "learned_sigma" else 1, aux)
    opts = dict(rep_cond=kind == "mse_rep", causal_modeling=True, kl_weight=0.3)

    def jax_terms(wj):
        return jd.training_losses(jax_fn(wj), jnp.asarray(x0), jnp.asarray(t, jnp.int32),
                                  None, c=jnp.asarray(c), noise=jnp.asarray(noise), **opts)

    want = jax_terms(jnp.asarray(w))
    want_grad = jax.grad(lambda wj: jax_terms(wj)["loss"].sum())(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = pd.training_losses(torch_fn(wt), torch.from_numpy(x0), torch.from_numpy(t),
                             c=torch.from_numpy(c), noise=torch.from_numpy(noise), **opts)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    (got_grad,) = torch.autograd.grad(got["loss"].sum(), wt, retain_graph=True)
    _close(got_grad, want_grad)
    if kind == "learned_sigma":  # the vb term trains the variance head only
        (vb_grad,) = torch.autograd.grad(got["vb"].sum(), wt)
        assert float(vb_grad[0].abs().max()) == 0.0 and float(vb_grad[1].abs().max()) > 0


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_encoder_train_mode_batchnorm_matches_flax(bf16):
    """Train-mode encode: outputs and new running statistics against flax
    (mutable batch_stats). bf16 trunk: the two frameworks round each conv's
    output at other points (torch adds the bias before its one rounding, flax
    after), and normalising with the batch's own statistics (12 values per
    channel in the last layer here) magnifies those ulps, so the outputs are
    held to RMS(diff) <= 5e-2 RMS(want) and max|diff| <= 8e-2 max|want|, the
    UNet tests' bf16 bound. The batch mean of bf16 conv outputs (|h| ~ 1) may
    differ by a bf16 ulp (2^-8) of its terms, which the update scales by 0.1:
    the statistics are held to atol 4e-4 (0.1 * 2^-8), rtol 1e-2. torch's F.batch_norm would update the running variance with
    the unbiased batch variance, which differs here by the factor n/(n-1)."""
    jax_cfg, port_cfg = configs(use_bf16=bf16)
    jmodel, variables = flax_variables(jax_cfg, seed=4)
    pmodel = port_model(port_cfg, variables).train()
    x = np.clip(np.random.RandomState(5).randn(3, 28, 28, 1), -1, 1).astype(np.float32)
    (mu_j, var_j), new = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, method=JaxUNet.encode, mutable=["batch_stats"]))(variables, x)
    mu_p, var_p = pmodel.encode(torch.from_numpy(x))
    for got, want in ((mu_p, mu_j), (var_p, var_j)):
        if bf16:
            _assert_bf16_close(_np(got), _np(want))
        else:
            _close(got, want, atol=1e-5, rtol=1e-4)
    stats = new["batch_stats"]["rep_emb"]["trunk"]
    stat_tol = dict(atol=4e-4, rtol=1e-2) if bf16 else dict(atol=1e-6, rtol=1e-5)
    h = pmodel.rep_emb.encoder[0][0](torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, block in enumerate(pmodel.rep_emb.encoder):
        bn = block[1]
        _close(bn.running_mean, stats[f"BatchNorm_{i}"]["mean"], **stat_tol)
        _close(bn.running_var, stats[f"BatchNorm_{i}"]["var"], **stat_tol)
    # torch's own train-mode update of the first layer, from the same start
    bn0 = variables["batch_stats"]["rep_emb"]["trunk"]["BatchNorm_0"]
    rm, rv = torch.from_numpy(bn0["mean"].copy()), torch.from_numpy(bn0["var"].copy())
    torch.nn.functional.batch_norm(h.detach(), rm, rv, training=True, momentum=0.1)
    n = h.shape[0] * h.shape[2] * h.shape[3]
    unbiased_excess = 0.1 * np.asarray(stats["BatchNorm_0"]["var"] - 0.9 * bn0["var"]) / (n - 1)
    assert np.abs(rv.numpy() - np.asarray(stats["BatchNorm_0"]["var"])).max() \
        > 0.5 * np.abs(unbiased_excess).max() > 0


def test_sampler_push_with_duplicates_and_weights_match():
    rng = np.random.RandomState(6)
    N, size = 12, 10
    counts = np.array([10, 9, 3, 0, 10, 10, 1, 10, 10, 10, 10, 10], np.int32)
    history = (rng.rand(N, size) * (np.arange(size) < counts[:, None])).astype(np.float32)
    t = np.array([1, 1, 1, 2, 0, 0, 3, 3, 11, 1])
    losses = rng.rand(len(t)).astype(np.float32)
    want = js.update_sampler_state({"history": jnp.asarray(history), "counts": jnp.asarray(counts)},
                                   jnp.asarray(t, jnp.int32), jnp.asarray(losses))
    got = ts.update_sampler_state({"history": history, "counts": counts},
                                  torch.from_numpy(t), torch.from_numpy(losses))
    np.testing.assert_array_equal(got["counts"], np.asarray(want["counts"]))
    np.testing.assert_array_equal(got["history"], np.asarray(want["history"]))
    # warmed up: every row full -> loss-aware weights
    full = {"history": rng.rand(N, size).astype(np.float32), "counts": np.full(N, size, np.int32)}
    jfull = {k: jnp.asarray(v) for k, v in full.items()}
    _close(ts.sampler_weights(full, N), js._weights(jfull, N), atol=0, rtol=1e-6)
    jt, jw = js.sample_timesteps(jfull, N, 64, jax.random.PRNGKey(0))
    _close(ts.timestep_weights(full, N, torch.from_numpy(np.asarray(jt, np.int64))), jw,
           atol=0, rtol=1e-5)
    pt, pw = ts.sample_timesteps(full, N, 64, torch.Generator().manual_seed(0), "cpu")
    assert pt.shape == (64,) and 0 <= int(pt.min()) and int(pt.max()) < N and pw.shape == (64,)
    assert ts.sampler_weights({"history": full["history"], "counts": counts}, N).tolist() \
        == [1.0] * N  # not warmed up yet: uniform


def test_kl_weight_anneal_matches():
    for step in (0, 1, 7, 49998, 49999, 60000):
        assert kl_weight_for_step(step, 50000) == float(jax_kl_weight(jnp.int32(step), 50000))


def test_adamw_with_decay_anneal_and_skip_matches_optax():
    """torch's fused AdamW + anneal_lr_ against optax.adamw with the
    reference's LR schedule, over 4 updates, with a skipped step (found_inf
    = 1) after the second: params stay, and the count does not advance."""
    cfg = Config(lr=1e-2, weight_decay=0.1, lr_anneal_steps=6)
    rng = np.random.RandomState(7)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(4)]
    tx = jax_make_optimizer(cfg)
    jp = jnp.asarray(p0)
    opt = tx.init(jp)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer = make_optimizer(cfg, [param])
    for i, g in enumerate(grads[:2] + [np.full_like(grads[0], np.nan)] + grads[2:]):
        skip = bool(np.isnan(g).any())
        param.grad = torch.from_numpy(g)
        optimizer.found_inf = torch.tensor(float(skip))
        before = param.detach().clone()
        anneal_lr_(optimizer, cfg)
        optimizer.step()
        if skip:
            assert torch.equal(param.detach(), before)
            assert float(optimizer.state[param]["step"]) == 2
    _close(param, jp, atol=1e-6, rtol=1e-5)


def test_synthetic_data_matches_jax():
    """The port's synthetic MorphoMNIST pool and its batch iterator give the
    JAX package's arrays, bit for bit, from the same seed."""
    from causaldiffae_tpu.data import synthetic_dataset as jax_dataset
    from causaldiffae_tpu.data import synthetic_iterator as jax_iterator
    from causaldiffae_torch.data import synthetic_dataset, synthetic_iterator

    got, want = synthetic_dataset("morphomnist", 64, seed=0), jax_dataset("morphomnist", 64, seed=0)
    assert sorted(got) == sorted(want) == ["c", "image", "y"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    it = synthetic_iterator("morphomnist", 8, seed=3)
    jit_ = jax_iterator("morphomnist", 8, seed=3, native=False, shard=False)
    for _ in range(3):
        got, want = next(it), next(jit_)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m causaldiffae_torch.train --device cpu`` on a tiny preset for
    2 steps, from flax weights in an .npz: two finite JSON lines (each
    logged one interval late), the same rows in progress.csv, a checkpoint
    at the end, no kernel launches (CPU tensors take the plain versions)."""
    from causaldiffae_torch import train
    from causaldiffae_torch.ops import attention as ops
    from causaldiffae_torch.utils.weights import flatten_variables

    jax_cfg, port_cfg = configs(use_bf16=True, batch_size=2)
    _, variables = flax_variables(jax_cfg, seed=8)
    npz = tmp_path / "weights.npz"
    np.savez(npz, **flatten_variables(variables))
    monkeypatch.setattr(train, "get_config", lambda name: port_cfg)
    launches = ops.attention_fwd.launches, ops.attention_bwd.launches
    state, records = train.main(["--total_steps", "2", "--log_interval", "1", "--device", "cpu",
                                 "--init_from", str(npz), "--logdir", str(tmp_path / "log")])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert lines == records and [r["step"] for r in lines] == [1, 2] and state.step == 2
    for r in lines:
        assert all(np.isfinite(r[k]) for k in ("loss", "mse", "kld_rep", "grad_norm",
                                                "step_time_s", "samples_per_sec"))
        assert r["step_skipped"] == 0.0
    with open(tmp_path / "log" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["step"]) for r in rows] == [1.0, 2.0]
    assert [float(r["loss"]) for r in rows] == [r["loss"] for r in records]
    assert (tmp_path / "log" / "checkpoints" / "tiny" / "step_2.pt").exists()
    assert (ops.attention_fwd.launches, ops.attention_bwd.launches) == launches
    with pytest.raises(SystemExit):
        train.parse_args(["--total_steps", "0"])
