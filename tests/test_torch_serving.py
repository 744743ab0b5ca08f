"""The port's diffusion process, sampling chains and counterfactual serving
against the JAX package's.

- schedules and respacing: every array equal to the JAX package's;
- chains: DDIM-10 and DPM++-10 from an injected x_t with a closed-form
  eps model, and DPM++ at order 1 equal to DDIM at eta 0;
- end to end: ``make_counterfactual_fn`` (pre and post intervention) on a
  tiny CausalUNet against the JAX function itself, with the JAX function's
  own ``r_noise``/``r_rep`` draws rebuilt from its ``rng`` and handed over;
- the serve CLI on the CPU: the requests and answers of every preset
  family (class-conditional, representation-only, context-conditional),
  ``--input`` files, and answers from a train CLI checkpoint.

Tolerances: fp32 atol 2e-4, rtol 1e-3 unless stated.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import (configs, flax_variables, one_torch_thread,  # noqa: F401
                            port_model)
from causaldiffae_tpu.diffusion import create_diffusion as jax_create_diffusion
from causaldiffae_tpu.diffusion import sampling as jax_sampling
from causaldiffae_tpu.evals.counterfactual import make_counterfactual_fn as jax_make_cf
from causaldiffae_torch import serve
from causaldiffae_torch.diffusion import create_diffusion
from causaldiffae_torch.diffusion import sampling
from causaldiffae_torch.evals.counterfactual import make_counterfactual_fn
from causaldiffae_torch.ops.attention import attention_fwd

F32_TOL = dict(atol=2e-4, rtol=1e-3)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("schedule,steps,respacing", [
    ("linear", 1000, ""), ("linear", 1000, "250"), ("cosine", 1000, "ddim25"),
    ("linear", 2000, "250"), ("cosine", 2000, ""),
])
def test_schedules_equal_jax(schedule, steps, respacing):
    ours = create_diffusion(steps=steps, noise_schedule=schedule, timestep_respacing=respacing)
    theirs = jax_create_diffusion(steps=steps, noise_schedule=schedule,
                                  timestep_respacing=respacing)
    for name in theirs.schedule._fields:
        np.testing.assert_array_equal(getattr(ours.schedule, name),
                                      getattr(theirs.schedule, name), err_msg=name)
    if respacing:
        np.testing.assert_array_equal(ours.timestep_map, theirs.timestep_map)
    else:
        assert ours.timestep_map is None and theirs.timestep_map is None


def _eps_jax(x, t):
    return jnp.tanh(x) * jnp.cos(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1)


def _eps_torch(x, t):
    return torch.tanh(x) * torch.cos(t.float() / 100.0).reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("learn_sigma", [False, True], ids=["fixed", "learned_range"])
def test_p_mean_variance_with_guidance_matches(learn_sigma):
    ours = create_diffusion(steps=100, timestep_respacing="10", learn_sigma=learn_sigma)
    theirs = jax_create_diffusion(steps=100, timestep_respacing="10", learn_sigma=learn_sigma)
    rng = np.random.RandomState(0)
    C = 2 if learn_sigma else 1
    x = rng.randn(4, 6, 6, 1).astype(np.float32)
    t = np.array([0, 3, 7, 9])
    # learned range: the model's second channel block is the variance value
    uncond_j = lambda xx, tt: jnp.concatenate([0.5 * _eps_jax(xx, tt)] * C, -1)
    cond_j = lambda xx, tt: jnp.concatenate([_eps_jax(xx, tt)] * C, -1)
    cond_t = lambda xx, tt: torch.cat([_eps_torch(xx, tt)] * C, -1)
    uncond_t = lambda xx, tt: torch.cat([0.5 * _eps_torch(xx, tt)] * C, -1)
    want = theirs.p_mean_variance(cond_j, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                  w=1.5, uncond_fn=uncond_j)
    got = ours.p_mean_variance(cond_t, torch.from_numpy(x), torch.from_numpy(t),
                               w=1.5, uncond_fn=uncond_t)
    for key in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(np.broadcast_to(got[key].numpy(), x.shape),
                                   np.broadcast_to(np.asarray(want[key]), x.shape),
                                   err_msg=key, **F32_TOL)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_chains_from_injected_xt_match(sampler):
    ours = create_diffusion(steps=1000, timestep_respacing="250")
    theirs = jax_create_diffusion(steps=1000, timestep_respacing="250")
    x_t = np.random.RandomState(1).randn(3, 8, 8, 1).astype(np.float32)
    if sampler == "ddim":
        ours = create_diffusion(steps=100, timestep_respacing="10")
        theirs = jax_create_diffusion(steps=100, timestep_respacing="10")
        want = jax_sampling.ddim_sample_loop(theirs, _eps_jax, jnp.asarray(x_t),
                                             jax.random.PRNGKey(0))
        got = sampling.ddim_sample_loop(ours, _eps_torch, torch.from_numpy(x_t))
    else:
        want = jax_sampling.dpm_solver_pp_loop(theirs, _eps_jax, jnp.asarray(x_t),
                                               num_steps=10)
        got = sampling.dpm_solver_pp_loop(ours, _eps_torch, torch.from_numpy(x_t),
                                          num_steps=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_dpm_order1_equals_ddim_eta0():
    diff = create_diffusion(steps=100, timestep_respacing="10")
    x_t = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 8, 1).astype(np.float32))
    ddim = sampling.ddim_sample_loop(diff, _eps_torch, x_t, eta=0.0)
    dpm1 = sampling.dpm_solver_pp_loop(diff, _eps_torch, x_t, order=1)
    torch.testing.assert_close(dpm1, ddim, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_fp32():
    jax_cfg, port_cfg = configs(use_bf16=False)
    model, variables = flax_variables(jax_cfg)
    return jax_cfg, port_cfg, model, variables, port_model(port_cfg, variables)


@pytest.mark.parametrize("var,where", [(0, "pre"), (1, "post")])
def test_counterfactual_end_to_end_matches_jax(tiny_fp32, var, where):
    """DDIM over the 10-step respacing, abduction at t=9, in fp32."""
    jax_cfg, port_cfg, jmodel, variables, pmodel = tiny_fp32
    rng = np.random.RandomState(7)
    x = np.clip(rng.randn(2, 28, 28, 1) * 0.5, -1, 1).astype(np.float32)
    y = np.array([3, 8], np.int32)
    key = jax.random.PRNGKey(11)
    jfn = jax.jit(jax_make_cf(jax_cfg, jmodel, jax_create_diffusion(
        steps=100, timestep_respacing="10"), intervene_var=var, where="auto"))
    want = np.asarray(jfn(variables, jnp.asarray(x), {"y": jnp.asarray(y)}, 0.7, key))
    # the JAX function's own draws (counterfactual.py:105-109,139)
    r_noise, r_rep, _ = jax.random.split(key, 3)
    rep_noise = np.array(jax.random.normal(r_rep, (2, port_cfg.rep_dim), jnp.float32))
    noise = np.array(jax.random.normal(r_noise, x.shape, jnp.float32))
    fn = make_counterfactual_fn(port_cfg, pmodel, create_diffusion(steps=100,
                                timestep_respacing="10"), intervene_var=var, where=where)
    got = fn(torch.from_numpy(x), {"y": torch.from_numpy(y.astype(np.int64))}, 0.7,
             abduction_noise=torch.from_numpy(noise), rep_noise=torch.from_numpy(rep_noise))
    assert np.abs(want).max() > 0.1
    # ten chained UNet calls in fp32: atol 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


def test_reconstruct_matches_jax(tiny_fp32):
    """The identity counterfactual, with the JAX function's own draws handed
    over (counterfactual.py:172-182)."""
    from causaldiffae_tpu.evals.counterfactual import make_reconstruct_fn as jax_rec
    from causaldiffae_torch.evals.counterfactual import make_reconstruct_fn

    jax_cfg, port_cfg, jmodel, variables, pmodel = tiny_fp32
    x = np.clip(np.random.RandomState(8).randn(2, 28, 28, 1) * 0.5, -1, 1).astype(np.float32)
    y = np.array([1, 4], np.int32)
    key = jax.random.PRNGKey(5)
    r_noise, r_rep, _ = jax.random.split(key, 3)
    want = np.asarray(jax.jit(jax_rec(jax_cfg, jmodel, jax_create_diffusion(
        steps=100, timestep_respacing="10")))(variables, jnp.asarray(x), {"y": jnp.asarray(y)}, key))
    got = make_reconstruct_fn(port_cfg, pmodel, create_diffusion(steps=100, timestep_respacing="10"))(
        torch.from_numpy(x), {"y": torch.from_numpy(y.astype(np.int64))},
        abduction_noise=torch.from_numpy(np.array(jax.random.normal(r_noise, x.shape))),
        rep_noise=torch.from_numpy(np.array(jax.random.normal(r_rep, (2, port_cfg.rep_dim)))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


def test_prior_sample_is_the_chain_from_the_given_draws(tiny_fp32):
    from causaldiffae_torch.evals.counterfactual import make_prior_sample_fn

    _, port_cfg, _, _, pmodel = tiny_fp32
    diff = create_diffusion(steps=100, timestep_respacing="5")
    rng = np.random.RandomState(9)
    z = torch.from_numpy(rng.randn(2, port_cfg.rep_dim).astype(np.float32))
    x_T = torch.from_numpy(rng.randn(2, 28, 28, 1).astype(np.float32))
    y = torch.tensor([2, 5])
    got = make_prior_sample_fn(port_cfg, pmodel, diff, use_ddim=True)(
        x_T.shape, {"y": y}, z=z, x_T=x_T, device="cpu")
    with torch.no_grad():
        want = sampling.ddim_sample_loop(
            diff, lambda xx, tt: pmodel.denoise(xx, tt, y=y, z=z), x_T)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert float(got.abs().max()) <= 1.0  # the last DDIM step returns the clipped x0


def test_serve_cli_on_cpu(tiny_fp32, tmp_path, monkeypatch, capsys):
    """The CLI end to end at a tiny size: flax weights from an .npz,
    synthetic requests, two batches through DPM++-4, one JSON line each.
    On CPU tensors the attention takes its plain version and launches nothing."""
    from causaldiffae_torch.utils.weights import flatten_variables

    _, port_cfg, _, variables, pmodel = tiny_fp32
    npz = tmp_path / "weights.npz"
    np.savez(npz, **flatten_variables(variables))
    monkeypatch.setattr(serve, "get_config", lambda name: port_cfg.replace(use_bf16=True))
    launches = attention_fwd.launches
    out = tmp_path / "answers.npz"
    records = serve.main(["--init_from", str(npz), "--synthetic", "3", "--batch", "2",
                          "--value", "0.5", "--sampler", "dpm++", "--sample_steps", "4",
                          "--device", "cpu", "--out", str(out)])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [r["size"] for r in lines] == [2, 1] and lines == records
    assert all(r["finite"] and r["latency_s"] > 0 and r["unet_calls"] == 4 for r in lines)
    with np.load(out) as z:
        assert z["samples"].shape == (3, 28, 28, 1)
    assert attention_fwd.launches == launches


def test_serve_rejects_bad_arguments():
    with pytest.raises(SystemExit):
        serve.parse_args(["--synthetic", "2"])                       # no --value
    with pytest.raises(SystemExit):
        serve.parse_args(["--value", "1", "--synthetic", "2", "--sampler", "ddim",
                          "--sample_steps", "5"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--value", "1"])                            # no requests


def _tiny_preset(name):
    """The preset at a tiny width (and 32x32 for the 96- and 128-pixel ones)."""
    from causaldiffae_torch.config import get_config

    cfg = get_config(name)
    return cfg.replace(num_channels=32, num_res_blocks=1, num_heads=2, rep_dim=32,
                       image_size=28 if cfg.image_size == 28 else 32, diffusion_steps=100,
                       eval_timestep_respacing="3", abduction_t=2)


@pytest.mark.parametrize("preset,keys", [
    ("morphomnist_causaldae", {"x", "y"}),   # class-conditional, with a representation
    ("pendulum_causaldae", {"x"}),           # representation only
    ("circuit_diffae", {"x"}),               # representation without a causal graph
    ("circuit_conditional", {"x", "c"}),     # context-conditional
    ("morphomnist_conditional", {"x", "y", "c"}),
])
def test_serve_cli_serves_every_preset_family(preset, keys, monkeypatch, capsys):
    """``serve --preset <p> --synthetic 16 --value 1 --device cpu``: requests
    carry what the preset conditions on, and every family answers."""
    cfg = _tiny_preset(preset)
    req = serve.synthetic_requests(cfg, 16, seed=3)
    assert set(req) == keys and req["x"].shape == (16, cfg.image_size, cfg.image_size,
                                                   cfg.in_channels)
    if "c" in keys:
        from causaldiffae_torch.data import synthetic_dataset

        np.testing.assert_array_equal(req["c"], synthetic_dataset(cfg.dataset, 16, seed=3)["c"])
    monkeypatch.setattr(serve, "get_config", lambda name: cfg)
    records = serve.main(["--preset", preset, "--synthetic", "16", "--value", "1",
                          "--device", "cpu", "--intervene_var", "1"])
    assert len(records) == 1 and records[0]["size"] == 16 and records[0]["finite"]
    assert records[0]["unet_calls"] == 3
    assert [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()] == records


def test_context_counterfactual_edits_the_context(monkeypatch):
    """A context model's do(var = value) regenerates from c with column var
    set, and the answer depends on the value."""
    cfg = _tiny_preset("circuit_conditional")
    model = serve.build_model(cfg, "", 0, "cpu")
    from causaldiffae_torch.utils.weights import fill_normal_

    fill_normal_(model, torch.Generator().manual_seed(1), std=0.05)
    req = serve.synthetic_requests(cfg, 2, seed=0)
    run = lambda value: next(serve.serve(cfg, model, req, intervene_var=2, value=value,
                                         batch=2, device="cpu"))["samples"]
    assert not np.array_equal(run(0.0), run(1.0))
    seen = []
    monkeypatch.setattr(model, "denoise", lambda x, t, y=None, c=None, z=None:
                        seen.append(c.clone()) or torch.zeros_like(x))
    run(0.25)
    want = torch.from_numpy(req["c"]).clone()
    want[:, 2] = 0.25
    assert len(seen) == 3 and all(torch.equal(c, want) for c in seen)  # 3 chain steps


def test_load_requests_takes_what_the_preset_needs(tmp_path):
    from causaldiffae_torch.config import get_config

    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    y, c = np.arange(3), rng.rand(3, 4).astype(np.float32)
    np.savez(tmp_path / "all.npz", x=x, y=y, c=c)
    np.savez(tmp_path / "x_only.npz", x=x)
    np.savez(tmp_path / "short_c.npz", x=x, c=c[:2])
    got = serve.load_requests(get_config("circuit_causaldae"), str(tmp_path / "all.npz"))
    assert set(got) == {"x"}                                          # y and c ignored
    got = serve.load_requests(get_config("circuit_conditional"), str(tmp_path / "all.npz"))
    assert set(got) == {"x", "c"}
    with pytest.raises(SystemExit, match=r"missing \['c'\]"):
        serve.load_requests(get_config("circuit_conditional"), str(tmp_path / "x_only.npz"))
    with pytest.raises(SystemExit, match=r"missing \['y'\]"):
        serve.load_requests(get_config("morphomnist_causaldae"), str(tmp_path / "x_only.npz"))
    with pytest.raises(SystemExit, match="length"):
        serve.load_requests(get_config("circuit_conditional"), str(tmp_path / "short_c.npz"))


def test_serve_cli_answers_from_a_checkpoint(tmp_path, monkeypatch, capsys):
    """The serve CLI loads what the train CLI saved, with the config it was
    trained with (here the overrides --ema_rate and --predict_xstart): with
    --use_ema that config's first EMA rate's weights, else the raw ones, and
    the BatchNorm buffers."""
    from causaldiffae_torch import train
    from causaldiffae_torch.training import CheckpointManager

    cfg = _tiny_preset("pendulum_causaldae").replace(batch_size=2)
    monkeypatch.setattr(train, "get_config", lambda name: cfg)
    ck = tmp_path / "ck"
    state, _ = train.main(["--preset", "pendulum_causaldae", "--synthetic", "--device", "cpu",
                           "--total_steps", "2", "--ckpt_dir", str(ck), "--ema_rate", "0.5",
                           "--predict_xstart", "true"])
    saved = CheckpointManager(str(ck)).load()
    trained = cfg.replace(ema_rate="0.5", predict_xstart=True, total_steps=2)
    for use_ema, weights in (("true", saved["ema"]["0.5"]), ("false", saved["model"])):
        got_cfg, model, step = serve.load_checkpoint(str(ck), use_ema == "true", "cpu")
        assert got_cfg == trained and step == 2
        sd = model.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in weights.items())
        assert all(torch.equal(sd[k], v) for k, v in saved["model"].items() if "running" in k)
        records = serve.main(["--ckpt_dir", str(ck), "--use_ema", use_ema, "--synthetic", "2",
                              "--value", "0.5", "--device", "cpu"])
        assert records[0]["finite"] and records[0]["unet_calls"] == 3
    assert not all(torch.equal(saved["ema"]["0.5"][k], saved["model"][k])
                   for k in saved["ema"]["0.5"])
    with pytest.raises(SystemExit, match="trained as pendulum_causaldae"):
        serve.main(["--preset", "circuit_causaldae", "--ckpt_dir", str(ck), "--synthetic", "2",
                    "--value", "1", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--ckpt_dir", str(tmp_path / "none"), "--synthetic", "2", "--value", "1",
                    "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--ckpt_dir", str(ck), "--init_from", "w.npz", "--synthetic", "2",
                          "--value", "1"])
