"""The flow prior (``flow_based=True``) of the port against the JAX package.

Tiny morphomnist-like config (2 variables, rep 32, so k = 16), every weight
filled from a numpy seed and carried across with ``state_dict_from_flax``:

- ``MultivariateCausalFlow.flow`` and ``reverse`` on the same numpy inputs;
- the training forward of a flow model with ``masking=True`` (z_post from the
  flow, the keep-mask overwriting the flow's mask) and its representation KL;
- one whole fp32 train step with ``flow_based=True, masking=False`` against
  ``make_train_step`` (``_port_fixtures.StepPair``; the port's counterpart of
  ``tests/test_train_step.py::test_train_step_flow_based``): the metrics,
  every gradient (the flow's through the scalar mask -mean(log_det)
  included), the new params and the EMA;
- the ``causal_flow`` weights flax -> port -> reference keys and back, bitwise;
- evaluation of a flow model raising in both packages.

fp32 tolerances: atol 2e-4, rtol 1e-3 (``tests/test_torch_parity.py``); a
gradient within atol 2e-4 of its tensor's largest entry (never below 1e-3
of the global RMS), new params and EMA within ``PARAM_ATOL`` (an AdamW step
moves a parameter by about +-lr, see ``tests/test_torch_train_step.py``).
"""

import numpy as np
import pytest
import torch

from _port_fixtures import (F32_TOL, PARAM_ATOL, STEP0, StepPair, configs, flax_variables,
                            make_batch, one_torch_thread, port_model)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(**overrides):
    jcfg, pcfg = configs(False, flow_based=True, **overrides)
    jmodel, variables = flax_variables(jcfg, seed=5)
    return jcfg, pcfg, jmodel, variables, port_model(pcfg, variables)


def _C(pcfg):
    from causaldiffae_torch.config import ADJACENCY

    return np.eye(pcfg.n_vars, dtype=np.float32) - np.asarray(ADJACENCY[pcfg.dataset],
                                                              np.float32)


def test_flow_and_reverse_match_jax():
    import jax.numpy as jnp

    jcfg, pcfg, jmodel, variables, model = _pair(masking=False)
    rng = np.random.RandomState(0)
    e = rng.randn(6, pcfg.rep_dim).astype(np.float32)
    C = _C(pcfg)
    z_j, ld_j = jmodel.apply(variables, jnp.asarray(e), jnp.asarray(C),
                             method=lambda m, e, C: m.causal_flow.flow(e, C))
    rld_j, lp_j = jmodel.apply(variables, z_j, jnp.asarray(C),
                               method=lambda m, z, C: m.causal_flow.reverse(z, C))
    with torch.no_grad():
        z_p, ld_p = model.causal_flow.flow(torch.from_numpy(e), torch.from_numpy(C))
        rld_p, lp_p = model.causal_flow.reverse(torch.from_numpy(np.array(z_j)),
                                                torch.from_numpy(C))
    for got, want in ((z_p, z_j), (ld_p, ld_j), (rld_p, rld_j), (lp_p, lp_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert z_p.shape == (6, pcfg.rep_dim) and ld_p.shape == (6,)
    # the reference's quirk: not an exact inverse (reverse reads C's self block)
    assert not np.allclose(-rld_p.numpy(), ld_p.numpy(), atol=1e-3)
    # the model's C is I - A of the dataset's graph, not a parameter
    assert torch.equal(model.flow_C, torch.from_numpy(C))
    assert "flow_C" not in model.state_dict() and not hasattr(model, "causal_mask")


def test_flow_forward_with_masking_matches_jax():
    """z_post from the flow, then the keep-mask gates z and z_post and replaces
    the flow's mask; eps, the aux terms and the representation KL as JAX's."""
    import jax
    import jax.numpy as jnp

    from causaldiffae_tpu.config import create_diffusion as jax_create_diffusion
    from causaldiffae_torch.config import create_diffusion

    jcfg, pcfg, jmodel, variables, model = _pair(masking=True)
    batch = make_batch(3)
    t = np.array([5, 50, 97, 20], np.int32)
    rngs = {"reparam": jax.random.PRNGKey(1), "cfmask": jax.random.PRNGKey(5)}
    (eps_j, aux_j), _ = jmodel.apply(
        variables, jnp.asarray(batch["image"]), jnp.asarray(t), y=jnp.asarray(batch["y"]),
        x_start=jnp.asarray(batch["image"]), train=True, rngs=rngs, mutable=["batch_stats"])
    rep, keep = jmodel.apply({}, method=lambda m: (
        jax.random.normal(m.make_rng("reparam"), (4, jcfg.rep_dim)),
        jax.random.bernoulli(m.make_rng("cfmask"), 1.0 - jcfg.drop_prob, (4,))), rngs=rngs)
    assert 0 < int(np.asarray(keep).sum()) < 4  # the mask gates some rows, not all
    kld_j = jax_create_diffusion(jcfg).representation_loss(
        aux_j["mu"], aux_j["var"], aux_j["z_post"], True, aux_j["mask"],
        jnp.asarray(batch["c"]))
    model.train()
    x = torch.from_numpy(batch["image"])
    eps_p, aux_p = model(x, torch.from_numpy(t.astype(np.int64)),
                         y=torch.from_numpy(batch["y"].astype(np.int64)), x_start=x,
                         rep_noise=torch.from_numpy(np.asarray(rep)),
                         keep=torch.from_numpy(np.asarray(keep, np.float32)))
    kld_p = create_diffusion(pcfg).representation_loss(
        aux_p["mu"], aux_p["var"], aux_p["z_post"], True, aux_p["mask"],
        torch.from_numpy(batch["c"]))
    np.testing.assert_allclose(eps_p.detach().numpy(), np.asarray(eps_j), **F32_TOL)
    for k in ("mu", "var", "z_post", "mask"):
        np.testing.assert_allclose(aux_p[k].detach().numpy(), np.asarray(aux_j[k]),
                                   err_msg=k, **F32_TOL)
    np.testing.assert_allclose(float(kld_p.detach()), float(kld_j), **F32_TOL)


def test_flow_train_step_matches_jax():
    """One fp32 step, flow_based=True and masking=False: the KL's mask is the
    flow's scalar -mean(log_det), and its gradient reaches the flow."""
    pair = StepPair(False, flow_based=True, masking=False)
    jm, pm = pair.step(make_batch(0))
    for k in ("loss", "mse", "kld_rep", "grad_norm", "param_norm", "kl_weight", "step_skipped"):
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **F32_TOL)
    want = pair.jax_grads()
    rms = float(np.sqrt(np.mean(np.concatenate([w.ravel() for w in want.values()]) ** 2)))
    flow_grads = 0
    for name, p in pair.pmodel.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=max(2e-4 * float(np.abs(w).max()), 1e-3 * rms),
                                   err_msg=name)
        flow_grads += name.startswith("causal_flow.") and bool(p.grad.abs().max() > 0)
    assert flow_grads == 12  # every weight and bias of both conditioners
    params = dict(pair.pmodel.named_parameters())
    new = pair.port_sd(pair.jstate.params)
    for name, v in pair.pmodel.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = dict(atol=PARAM_ATOL, rtol=0) if name in params else F32_TOL
        np.testing.assert_allclose(v.numpy(), new[name], err_msg=name, **tol)
    ema = pair.port_sd(pair.jstate.ema_params["0.9999"])
    for name, v in pair.pstate.ema["0.9999"].items():
        np.testing.assert_allclose(v.numpy(), ema[name], atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert pair.pstate.step == STEP0 + 1


def test_causal_flow_weights_round_trip_bitwise():
    """flax -> the port's state_dict -> reference keys (the JAX package's
    export) and back to flax: every tensor bitwise, loaded with strict=True."""
    from causaldiffae_tpu.utils.torch_port import export_torch_state_dict, port_torch_state_dict
    from causaldiffae_torch.utils.weights import state_dict_from_flax

    jcfg, pcfg, _, variables, model = _pair(masking=False)
    got = state_dict_from_flax(pcfg, variables)
    want = export_torch_state_dict(jcfg, variables)
    assert list(got) == list(want)
    flow_keys = [k for k in got if k.startswith("causal_flow.")]
    assert sorted(flow_keys) == sorted(f"causal_flow.{m}.{j}.{w}" for m in ("s_cond", "t_cond")
                                       for j in (0, 2, 4) for w in ("weight", "bias"))
    for k, v in want.items():
        assert got[k].numpy().tobytes() == np.ascontiguousarray(v).tobytes(), k
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = port_torch_state_dict(jcfg, sd)["params"]["causal_flow"]
    for m in ("s_cond", "t_cond"):
        for dense in ("Dense_0", "Dense_1", "Dense_2"):
            for w in ("kernel", "bias"):
                a = np.asarray(back[m][dense][w])
                b = np.asarray(variables["params"]["causal_flow"][m][dense][w])
                assert a.tobytes() == b.tobytes(), (m, dense, w)


def test_flow_evaluation_raises_as_in_jax():
    """A flow model has no SCM ``causal_mask``: JAX's encode_and_causalize
    fails on it, and the port's raises in the same place."""
    import jax
    import jax.numpy as jnp

    jcfg, pcfg, jmodel, variables, model = _pair(masking=False)
    x = make_batch(1)["image"]
    with pytest.raises(AttributeError):
        jmodel.apply(variables, jnp.asarray(x), method=lambda m, x: m.encode_and_causalize(x),
                     rngs={"reparam": jax.random.PRNGKey(0)})
    with pytest.raises(AttributeError, match="flow"):
        model.encode_and_causalize(torch.from_numpy(x))
