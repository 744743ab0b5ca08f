"""The port's evaluation modules against the JAX package's.

- the probe (``GaussianConvEncoderClf``): forward and ``features`` in eval
  mode, one train step (loss, new params, new BatchNorm statistics) from the
  same init and ``validate`` against the JAX trainer's ``_train_step`` and
  ``_eval_step``; a JAX pickle and a reference ``.pth``
  (``export_classifier_state_dict``) load into the port and predict as the
  JAX probe does;
- metrics, the Frechet distance and FID on the same arrays (bit-equal where
  both are numpy);
- the Inception head on random weights against the JAX head;
- ``ground_truth_factors`` for every dataset and variable, bit-equal.

Tolerances: fp32 atol 2e-4, rtol 1e-3 unless stated.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import one_torch_thread  # noqa: F401
from causaldiffae_tpu.evals import classifiers as jax_classifiers
from causaldiffae_tpu.evals import metrics as jax_metrics
from causaldiffae_tpu.evals import quality as jax_quality
from causaldiffae_tpu.models.encoder import GaussianConvEncoderClf as JaxClf
from causaldiffae_torch.evals import classifiers, metrics, quality
from causaldiffae_torch.models.encoder import GaussianConvEncoderClf
from causaldiffae_torch.utils.weights import classifier_state_dict_from_flax

F32_TOL = dict(atol=2e-4, rtol=1e-3)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _images(n, size, channels, seed=0):
    rng = np.random.RandomState(seed)
    return np.round(rng.rand(n, size, size, channels) * 255).astype(np.float32) / 255


def _jax_probe(n_vars, size, channels, seed=0):
    """A JAX probe with numpy-seeded params (shaped by eval_shape; kernels of
    variance 1 / fan_in) and non-trivial BatchNorm statistics."""
    model = JaxClf(num_vars=n_vars)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, size, size, channels)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:  # bias, mean
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _port_probe(variables, n_vars, size, channels):
    model = GaussianConvEncoderClf(channels, size, n_vars)
    model.load_state_dict(classifier_state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("n_vars,size,channels", [(2, 28, 1), (4, 32, 3), (4, 96, 4)])
def test_probe_forward_and_features_match_jax(n_vars, size, channels):
    jmodel, variables = _jax_probe(n_vars, size, channels)
    pmodel = _port_probe(variables, n_vars, size, channels)
    x = _images(3, size, channels)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    want_f = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False,
                                     method=JaxClf.features))
    with torch.no_grad():
        got, got_f = pmodel(torch.from_numpy(x)), pmodel.features(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 1) and got_f.shape == want_f.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got_f.numpy(), want_f, **F32_TOL)   # (H, W, C) order


def test_probe_train_step_and_validate_match_jax():
    """One Adam step from the same init on the same batch: the loss, every
    new parameter and the new running statistics; then validate.

    A conv bias in front of train-mode BatchNorm has a zero gradient (the
    batch mean removes it), so its computed gradient is rounding noise of
    either package, and Adam's first step g / (|g| + eps) turns that noise
    into +-lr: those biases are held to their Adam bound |step| <= lr in both
    packages instead of to each other."""
    data = {"image": _images(16, 28, 1, seed=3),
            "c": np.random.RandomState(4).randn(16, 2).astype(np.float32)}
    jtr = jax_classifiers.ClassifierTrainer("morphomnist", factor=1, n_vars=2, seed=0)
    jtr.init(jnp.asarray(data["image"][:2]))
    variables = _numpy_tree({"params": jtr.params, "batch_stats": jtr.batch_stats})
    ptr = classifiers.ClassifierTrainer("morphomnist", factor=1, n_vars=2, seed=0, device="cpu")
    ptr.init(data["image"][:2])
    ptr.model.load_state_dict(classifier_state_dict_from_flax(variables), strict=True)

    x, c = data["image"][:8], data["c"][:8]
    params, batch_stats, _, jloss = jtr._train_step(jtr.params, jtr.batch_stats, jtr.opt_state,
                                                    jnp.asarray(x), jnp.asarray(c))
    ploss = ptr.train_step(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(float(ploss), float(jloss), **F32_TOL)
    want = classifier_state_dict_from_flax(_numpy_tree({"params": params,
                                                        "batch_stats": batch_stats}))
    got, init = ptr.model.state_dict(), classifier_state_dict_from_flax(variables)
    assert set(got) == set(want)
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("encoder.") and k.endswith(".0.bias"):
            for new in (got[k], want[k]):
                assert float((new - init[k]).abs().max()) <= 1e-3 * (1 + 1e-4), k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **F32_TOL)

    val = {"image": data["image"][8:], "c": data["c"][8:]}
    jval = float(jtr._eval_step(params, batch_stats, jnp.asarray(val["image"]),
                                jnp.asarray(val["c"])))
    np.testing.assert_allclose(ptr.validate(val), jval, **F32_TOL)
    np.testing.assert_allclose(ptr.validate(val, batch_size=3), jval, **F32_TOL)


def test_fit_keeps_the_best_epoch_and_the_pickle_round_trips(tmp_path):
    """fit keeps the weights of its best validation epoch (strict <), the
    pickle loads back into an equal probe, and the pool-on-host path (a pool
    above the byte limit) trains the same weights as the pool-on-device one."""
    from causaldiffae_torch.data import synthetic_dataset

    data = synthetic_dataset("morphomnist", 96, seed=3)
    train, val = ({k: v[:80] for k, v in data.items()}, {k: v[80:] for k, v in data.items()})
    tr = classifiers.ClassifierTrainer("morphomnist", 0, 2, seed=1, device="cpu")
    best = tr.fit(train, val, epochs=3, batch_size=32)
    tr.model.load_state_dict(best)
    assert tr.validate(val) == tr.best_val
    tr.save_best(str(tmp_path / "p.pkl"))
    model, meta = classifiers.load_classifier(str(tmp_path / "p.pkl"), 2, 28, 1)
    assert meta == {"dataset": "morphomnist", "factor": 0, "best_val": tr.best_val}
    assert all(torch.equal(model.state_dict()[k], v) for k, v in best.items())

    host = classifiers.ClassifierTrainer("morphomnist", 0, 2, seed=1, device="cpu")
    limit = classifiers.POOL_BYTE_LIMIT
    try:
        classifiers.POOL_BYTE_LIMIT = 0
        host_best = host.fit(train, val, epochs=3, batch_size=32)
    finally:
        classifiers.POOL_BYTE_LIMIT = limit
    assert host.best_val == tr.best_val
    assert all(torch.equal(host_best[k], v) for k, v in best.items())


def test_jax_pickle_and_reference_pth_load_into_the_port(tmp_path):
    """A probe the JAX trainer pickled, and the same probe exported as a
    reference ``classifier_<var>_best.pth``, load into the port (strictly,
    the dead fc_mu/fc_var dropped by name) and predict as the JAX probe."""
    from causaldiffae_tpu.data import synthetic_dataset
    from causaldiffae_tpu.utils.torch_port import export_classifier_state_dict

    data = synthetic_dataset("morphomnist", 64, seed=5)
    jtr = jax_classifiers.ClassifierTrainer("morphomnist", factor=0, n_vars=2, seed=0)
    jtr.fit({k: v[:48] for k, v in data.items()}, {k: v[48:] for k, v in data.items()},
            epochs=2, batch_size=16)
    jtr.save_best(str(tmp_path / "classifier_morphomnist_thickness.pkl"))
    jmodel, jvars, jmeta = jax_classifiers.load_classifier(
        str(tmp_path / "classifier_morphomnist_thickness.pkl"), 2)
    x = data["image"][48:]
    want = np.asarray(jax_classifiers.classifier_predict_fn(jmodel, jvars)(jnp.asarray(x)))

    model, meta = classifiers.load_classifier(
        str(tmp_path / "classifier_morphomnist_thickness.pkl"), 2, 28, 1)
    assert meta["best_val"] == jmeta["best_val"] and meta["factor"] == 0
    got = classifiers.classifier_predict_fn(model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)

    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_classifier_state_dict(jvars).items()}
    torch.save(sd, tmp_path / "classifier_thickness_best.pth")
    model, meta = classifiers.load_classifier(str(tmp_path / "classifier_thickness_best.pth"),
                                              2, 28, 1)
    assert meta["source"] == "torch"
    got = classifiers.classifier_predict_fn(model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    for broken in ({**sd, "extra.weight": torch.zeros(1)},
                   {k: v for k, v in sd.items() if k != "encoder.0.1.running_var"}):
        torch.save(broken, tmp_path / "broken.pth")
        with pytest.raises(RuntimeError):
            classifiers.load_classifier(str(tmp_path / "broken.pth"), 2, 28, 1)


def _latents(seed=0, n=200, d=4):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, d)
    return z, z @ rng.randn(d, d) + 0.1 * rng.randn(n, d)


@pytest.mark.parametrize("name", ["compute_dci", "compute_irs", "mcc", "r2_disentanglement",
                                  "linear_disentanglement", "permutation_disentanglement"])
def test_metrics_bit_equal_jax(name):
    z, hz = _latents()
    binned = np.digitize(z, np.quantile(z, [0.25, 0.5, 0.75]))
    args = {
        "compute_dci": (hz[:100].T, z[:100].T, hz[100:].T, z[100:].T),
        "compute_irs": (hz.T, binned.T),
        "mcc": (z, hz),
        "r2_disentanglement": (z, hz),
        "linear_disentanglement": (z, hz, "pearson", True),
        "permutation_disentanglement": (z, hz, "spearman"),
    }[name]
    outs = []
    for module in (jax_metrics, metrics):
        np.random.seed(0)   # the boosted trees' feature order draws from the global stream
        outs.append(getattr(module, name)(*args))
    want, got = outs
    flat = lambda o: [np.asarray(a) for a in jax.tree_util.tree_leaves(o)]
    assert len(flat(got)) == len(flat(want))
    for a, b in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(a, b)


def test_frechet_distance_and_fid_match_jax():
    """The same features give bit-equal statistics, distances and FID; the
    probe trunk's features agree with the JAX trunk's, and so do their FIDs."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(64, 8), rng.randn(48, 8) * 1.2 + 0.3
    stats = [m.activation_statistics(x) for m in (jax_quality, quality) for x in (a, b)]
    for x, y in zip(stats[:2], stats[2:]):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    assert quality.frechet_distance(*stats[2], *stats[3]) == \
        jax_quality.frechet_distance(*stats[0], *stats[1])

    real, fake = _images(40, 28, 1, seed=1), _images(24, 28, 1, seed=2) * 0.8
    fids = []
    for m in (jax_quality, quality):
        fid = m.FID()
        fid.update(real, real=True)
        fid.update(fake, real=False)
        fids.append(fid.compute())
    assert fids[0] == fids[1]

    jmodel, variables = _jax_probe(2, 28, 1)
    jfeat = jax_quality.classifier_feature_fn(jmodel, variables, batch_size=16)
    pfeat = quality.default_feature_fn(_port_probe(variables, 2, 28, 1))
    np.testing.assert_allclose(pfeat(real), jfeat(real), **F32_TOL)
    fids = []
    for m, fn in ((jax_quality, jfeat), (quality, pfeat)):
        fid = m.FID(fn)
        fid.update(real, real=True)
        fid.update(fake, real=False)
        fids.append(fid.compute())
    np.testing.assert_allclose(fids[1], fids[0], rtol=1e-3)
    with pytest.raises(RuntimeError, match="weights file"):
        quality.inception_feature_fn()


@pytest.mark.parametrize("feature,size,channels", [(64, 28, 1), (192, 32, 3)])
def test_inception_head_matches_jax(tmp_path, feature, size, channels):
    from test_inception_fid import _random_state_dict

    from causaldiffae_tpu.evals.inception import inception_features, load_inception_head
    from causaldiffae_torch.evals.inception import head_feature_fn
    from causaldiffae_torch.evals.inception import load_inception_head as port_load

    torch.save(_random_state_dict(seed=3), tmp_path / "inception.pt")
    x = _images(2, size, channels, seed=4)
    want = np.asarray(inception_features(load_inception_head(str(tmp_path / "inception.pt"),
                                                             feature),
                                         jnp.asarray(x), feature=feature))
    got = head_feature_fn(port_load(str(tmp_path / "inception.pt"), feature))(x)
    assert got.shape == want.shape == (2, feature)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    sd = _random_state_dict()
    del sd["Conv2d_2b_3x3.bn.running_var"]
    torch.save(sd, tmp_path / "broken.pt")
    with pytest.raises(KeyError, match="Conv2d_2b_3x3.bn.running_var"):
        port_load(str(tmp_path / "broken.pt"), feature)


def test_ground_truth_factors_bit_equal_jax():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import counterfactual_test as jax_cli

    from causaldiffae_torch import interventions

    assert interventions.VAR_NAMES == jax_cli.VAR_NAMES
    assert interventions.INTERVENTION_RANGES == jax_cli.INTERVENTION_RANGES
    scales = {"morphomnist": [(3.4, 2.4), (161.0, 94.0)],
              "pendulum": [(2.0, 42.0), (104.0, 44.0), (7.5, 4.5), (11.0, 8.0)],
              "circuit": [(0.0, 1.0)] * 4}
    rng = np.random.RandomState(0)
    for dataset, names in jax_cli.VAR_NAMES.items():
        scale = np.asarray(scales[dataset])
        c_raw = rng.randn(16, len(names)) * scale[:, 1] + scale[:, 0]
        for var_idx, (lo, hi) in enumerate(jax_cli.INTERVENTION_RANGES[dataset]):
            value = rng.uniform(lo, hi)
            np.testing.assert_array_equal(
                interventions.ground_truth_factors(dataset, c_raw, var_idx, value),
                jax_cli.ground_truth_factors(dataset, c_raw, var_idx, value))
