"""One whole fp32 train step of the port against the JAX package's ``make_train_step``.

Same variables (a flax tree filled from a numpy seed, carried into the port
with ``state_dict_from_flax``), same batch, and the JAX step's own draws,
rebuilt from its rng and handed to the port (``_port_fixtures.StepPair``).
The config trains with ``microbatch`` = B/2, ``weight_decay`` > 0 and
``lr_anneal_steps`` > 0: two steps, then one with a NaN in the batch, which
both skip (params and optimizer state stay; the EMA, step, sampler and
BatchNorm state still move).

Compared after every step: loss, mse, kld_rep, grad norm, param norm, KL
weight, every parameter's gradient, the new params, the EMA and the new
batch_stats. fp32 atol 2e-4, rtol 1e-3 (for a gradient, atol 2e-4 of its
tensor's largest entry, never below 1e-3 of the gradients' global RMS: a
bias just before a normalisation has a true gradient of 0, where both sides
hold rounding noise). An AdamW step moves a parameter by about +-lr
whatever its gradient's size, in the direction of that noise where the
gradient is 0, so after k applied steps new params and the EMA are held to
atol k * 2.5e-4 (> 2 k lr). (The bf16 step: ``test_torch_train_step_bf16.py``.)
"""

import numpy as np
import torch

from _port_fixtures import F32_TOL, PARAM_ATOL, STEP0, STEP_B, StepPair, make_batch

METRICS = ("loss", "mse", "kld_rep", "grad_norm", "param_norm", "kl_weight", "step_skipped")


def _grads_close(pair):
    want = pair.jax_grads()
    rms = float(np.sqrt(np.mean(np.concatenate([w.ravel() for w in want.values()]) ** 2)))
    for name, p in pair.pmodel.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=max(2e-4 * float(np.abs(w).max()), 1e-3 * rms),
                                   err_msg=name)


def _state_close(pair, applied):
    param_atol = applied * PARAM_ATOL
    params = dict(pair.pmodel.named_parameters())
    want = pair.port_sd(pair.jstate.params)
    for name, v in pair.pmodel.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = dict(atol=param_atol, rtol=0) if name in params else F32_TOL
        np.testing.assert_allclose(v.numpy(), want[name], err_msg=name, **tol)
    ema = pair.port_sd(pair.jstate.ema_params["0.9999"])
    for name, v in pair.pstate.ema["0.9999"].items():
        np.testing.assert_allclose(v.numpy(), ema[name], atol=param_atol, rtol=0, err_msg=name)


def test_fp32_steps_match_jax_with_microbatch_decay_anneal_and_skip():
    pair = StepPair(False, microbatch=STEP_B // 2, weight_decay=0.05, lr_anneal_steps=4)
    for applied, seed in ((1, 0), (2, 1)):
        jm, pm = pair.step(make_batch(seed))
        assert jm["step_skipped"] == pm["step_skipped"] == 0.0
        for k in METRICS:
            np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **F32_TOL)
        _grads_close(pair)
        _state_close(pair, applied)
    params = {n: p.detach().clone() for n, p in pair.pmodel.named_parameters()}
    ema = {n: v.clone() for n, v in pair.pstate.ema["0.9999"].items()}
    jm, pm = pair.step(make_batch(2, nan=True))
    assert jm["step_skipped"] == pm["step_skipped"] == 1.0
    assert not np.isfinite(pm["grad_norm"]) and not np.isfinite(jm["grad_norm"])
    for n, p in pair.pmodel.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    assert {float(s["step"]) for s in pair.pstate.optimizer.state.values()} == {2.0}
    assert pair.pstate.step == STEP0 + 3 == int(pair.jstate.step)
    assert any(not torch.equal(ema[n], v) for n, v in pair.pstate.ema["0.9999"].items())
    _state_close(pair, 2)  # params, EMA and the (NaN) batch_stats as the JAX step left them
