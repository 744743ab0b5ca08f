"""One whole bf16 train step of the port against the JAX package's ``make_train_step``.

bf16 compute with fp32 params, on the whole batch; same variables, batch
and draws as ``test_torch_train_step.py`` (``_port_fixtures.StepPair``). The
JAX side runs its einsum attention, the port the kernels' plain versions,
whose bf16 d^-1/4 differs at d = 32 (ROADMAP, faults), and the two round at
other points all through the network. The encoder's gradients also pass
back through train-mode BatchNorm over 4 samples, whose batch statistics
magnify the bf16 rounding of each conv output (as in the forward, see
``test_torch_training.py``). Its conv biases feed a normalisation and have a
true gradient of 0: JAX sums their bf16-rounded cotangent, torch's conv
accumulates it in fp32, so the port's (noise) must be no larger than the
JAX package's, and they stay out of the other bounds. Bounds: the metrics
to rtol 2e-2; the other gradients together to RMS(diff) <= 1e-1 RMS; each
tensor's RMS(diff) to 5e-2 (the UNet's) or 1.5e-1 (the encoder's) of the
larger of its RMS and a tenth of the global RMS; new params and EMA to atol 2.5e-4 (> 2 lr)
where the gradient is large enough for its sign to survive the rounding
(|g| >= 5e-2 of its tensor's RMS); batch_stats to atol 4e-4, rtol 1e-2 (an
ulp of the mean |conv output|, times the update's 0.1).

The JAX side stays on its einsum attention: through its interpret-mode
Pallas kernels, which round where the port's plain versions do, the
differences do not shrink (global RMS(diff) 7.42% of RMS, against 7.40% on
the einsum route; the UNet's worst tensor 6.7% against 4.4%; the encoder's
11.8% on both), since they come from the
convolutions and the BatchNorm, and the step compiles ~7 s longer. The
attention's own rounding is held tightly in ``test_torch_attention_bwd.py``.
"""

import numpy as np

from _port_fixtures import PARAM_ATOL, StepPair, make_batch


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def test_bf16_step_matches_jax():
    pair = StepPair(True)
    jm, pm = pair.step(make_batch(3))
    for k in ("loss", "mse", "kld_rep", "grad_norm", "param_norm", "kl_weight", "step_skipped"):
        np.testing.assert_allclose(pm[k], jm[k], atol=1e-4, rtol=2e-2, err_msg=k)
    want = pair.jax_grads()
    zero = {f"rep_emb.encoder.{i}.0.bias" for i in range(len(pair.pmodel.rep_emb.encoder))}
    for n in zero:  # true gradient 0: the port's noise is no larger than JAX's
        assert _rms(pair.pmodel.get_parameter(n).grad.numpy()) <= _rms(want[n]) + 1e-6, n
    named = [(n, p) for n, p in pair.pmodel.named_parameters() if n not in zero]
    diff = np.concatenate([(p.grad.numpy() - want[n]).ravel() for n, p in named])
    total = np.concatenate([want[n].ravel() for n, _ in named])
    assert _rms(diff) <= 1e-1 * _rms(total), (_rms(diff), _rms(total))
    new = pair.port_sd(pair.jstate.params)
    ema = pair.port_sd(pair.jstate.ema_params["0.9999"])
    for n, p in named:
        rel = 1.5e-1 if n.startswith("rep_emb.") else 5e-2
        scale = max(_rms(want[n]), 0.1 * _rms(total))
        assert _rms(p.grad.numpy() - want[n]) <= rel * scale, (n, _rms(p.grad.numpy() - want[n]))
        sure = np.abs(want[n]) >= 5e-2 * _rms(want[n])
        np.testing.assert_allclose(p.detach().numpy()[sure], new[n][sure], atol=PARAM_ATOL,
                                   rtol=0, err_msg=n)
        np.testing.assert_allclose(pair.pstate.ema["0.9999"][n].numpy()[sure], ema[n][sure],
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)
    for i, block in enumerate(pair.pmodel.rep_emb.encoder):
        s = pair.jstate.batch_stats["rep_emb"]["trunk"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(block[1].running_mean.numpy(), s["mean"], atol=4e-4, rtol=1e-2)
        np.testing.assert_allclose(block[1].running_var.numpy(), s["var"], atol=4e-4, rtol=1e-2)
