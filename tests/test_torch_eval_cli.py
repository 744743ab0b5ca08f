"""The port's five evaluation CLIs end to end on the CPU at a tiny size.

``counterfactual_test``, ``classifier_train``, ``rescore_counterfactuals``,
``nll`` and ``sample`` with ``--device cpu`` on tiny presets (32 channels,
one res block, T = 8, three respaced steps): the JSON keys of the JAX CLIs,
the replay stamps of ``samples_do_<var>.npz``, a run that replays the JAX
CLI's ``RandomState`` stream (the JAX rescoring script, with the same JAX
probe pickles, gives the port run's MAE), a rescore that reproduces the
run's MAE, the DCI branch (sklearn is present here), the PNG writer's bytes
(signature, CRC, zlib round trip to the grid), and the refusals. The
effectiveness run blocks ``PIL`` and ``sklearn``, which the card's machine
lacks.
"""

import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from _port_fixtures import one_torch_thread  # noqa: F401
from causaldiffae_torch import (classifier_train, counterfactual_test, nll,
                                rescore_counterfactuals, sample)
from causaldiffae_torch.config import get_config
from causaldiffae_torch.evals import cli
from causaldiffae_torch.utils import logger
from causaldiffae_torch.utils.images import PNG_SIGNATURE, save_grid, write_png

SCRIPTS = str(Path(__file__).resolve().parent.parent / "scripts")
pytestmark = pytest.mark.usefixtures("one_torch_thread")
EFFECT_KEYS = {"mae_thickness", "mae_intensity", "clf_val_mse_thickness",
               "clf_val_mse_intensity"}


@pytest.fixture(autouse=True)
def unconfigure_the_logger():
    """The CLIs point the port's global logger at stderr; leave it unconfigured."""
    yield
    logger.close()


def _tiny(name):
    cfg = get_config(name)
    return cfg.replace(num_channels=32, num_res_blocks=1, num_heads=2, rep_dim=32,
                       image_size=28 if cfg.image_size == 28 else 32, diffusion_steps=8,
                       noise_schedule="cosine", eval_timestep_respacing="3", abduction_t=2)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(cli, "get_config", _tiny)
    monkeypatch.setattr(rescore_counterfactuals, "get_config", _tiny)


def _read_png(path):
    """Decode the writer's PNG: signature, chunk CRCs, IHDR, one zlib IDAT of
    unfiltered rows -> uint8 [H, W, C]."""
    data = Path(path).read_bytes()
    assert data[:8] == PNG_SIGNATURE
    pos, chunks = 8, {}
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * c)
    assert depth == 8 and b"IEND" in chunks and not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, c)


def _grid(images, ncol=8):
    n, h, w, c = images.shape
    ncol = min(ncol, n)
    grid = np.zeros(((n + ncol - 1) // ncol * h, ncol * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return (np.clip(grid, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_grid_round_trip(tmp_path, channels):
    images = np.random.RandomState(channels).rand(11, 5, 7, channels) * 1.4 - 0.2
    save_grid(images, str(tmp_path / "g.png"), ncol=4)
    np.testing.assert_array_equal(_read_png(tmp_path / "g.png"), _grid(images, ncol=4))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), images[0])   # float, not uint8


def test_counterfactual_cli_effectiveness_and_rescore(tiny, tmp_path, monkeypatch, capsys):
    """Probes trained in-process, reconstruction, traversals, 2 x 2 do()
    batches, FID over the probe trunk; stamps and grids; the rescore with the
    run's probes reproduces its MAE. PIL and sklearn are blocked."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    out = tmp_path / "run"
    result = counterfactual_test.main(["--device", "cpu", "--num_samples", "8",
                                       "--batch_size", "4", "--clf_epochs", "1",
                                       "--compute_fid", "--traversal", "--out_dir", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert set(result) == EFFECT_KEYS | {"fid"}
    assert all(np.isfinite(v) for v in result.values()) and result["fid"] >= 0
    for name in ("thickness", "intensity"):
        assert (out / f"classifier_morphomnist_{name}.pkl").exists()
        with np.load(out / f"samples_do_{name}.npz") as z:
            stamps = {k: int(z[k]) for k in z.files if k != "samples"}
            samples = z["samples"]
        assert stamps == {"seed": 0, "batch_size": 4, "num_samples": 8, "process_count": 1,
                          "synthetic_pool": 1}
        assert samples.shape == (8, 28, 28, 1) and np.abs(samples).max() <= 1.0
        np.testing.assert_array_equal(_read_png(out / f"grid_do_{name}.png"), _grid(samples))
        assert _read_png(out / f"traversal_{name}.png").shape == (8 * 28, 4 * 28, 1)
    with np.load(out / "reconstructions.npz") as z:
        pair = np.concatenate([z["original"], z["recon"]], 0)
    np.testing.assert_array_equal(_read_png(out / "reconstructions.png"), _grid(pair, ncol=4))

    (rescored,) = rescore_counterfactuals.main(
        ["--preset", "morphomnist_causaldae", "--classifier_dir", str(out), "--runs", str(out),
         "--num_samples", "8", "--batch_size", "4", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == rescored
    for name in ("thickness", "intensity"):
        np.testing.assert_allclose(rescored[f"mae_{name}"], result[f"mae_{name}"], rtol=1e-6)
    with pytest.raises(SystemExit, match="num_samples"):
        rescore_counterfactuals.main(["--preset", "morphomnist_causaldae", "--classifier_dir",
                                      str(out), "--runs", str(out), "--num_samples", "12",
                                      "--batch_size", "4", "--device", "cpu"])


def test_a_port_run_replays_the_jax_cli_stream(tiny, tmp_path, capsys):
    """Scored with the JAX package's probe pickles, a port run's MAE equals
    what the JAX rescoring script (which replays the JAX CLI's RandomState
    stream: probe batch, then per variable and batch the rows and the value)
    computes on the port run's samples: the same requests, values and
    ground truth."""
    from causaldiffae_tpu.data import synthetic_dataset as jax_synthetic_dataset
    from causaldiffae_tpu.evals import ClassifierTrainer as JaxTrainer

    clf = tmp_path / "clf"
    pool = jax_synthetic_dataset("morphomnist", 64, seed=2)
    val_mse = {}
    for f, name in enumerate(("thickness", "intensity")):
        tr = JaxTrainer("morphomnist", f, 2, seed=0)
        tr.fit({k: v[:48] for k, v in pool.items()}, {k: v[48:] for k, v in pool.items()},
               epochs=1, batch_size=16)
        tr.save_best(str(clf / f"classifier_morphomnist_{name}.pkl"))
        val_mse[name] = tr.best_val
    out = tmp_path / "run"
    result = counterfactual_test.main(["--device", "cpu", "--num_samples", "8", "--batch_size",
                                       "4", "--no_recon", "--classifier_dir", str(clf),
                                       "--out_dir", str(out), "--sampler", "dpm++",
                                       "--sample_steps", "2"])
    assert set(result) == EFFECT_KEYS
    for name, v in val_mse.items():
        assert result[f"clf_val_mse_{name}"] == v
    capsys.readouterr()
    sys.path.insert(0, SCRIPTS)
    import rescore_counterfactuals as jax_rescore

    argv = sys.argv
    sys.argv = ["rescore_counterfactuals.py", "--preset", "morphomnist_causaldae",
                "--classifier_dir", str(clf), "--runs", str(out), "--num_samples", "8",
                "--batch_size", "4", "--cpu"]
    try:
        jax_rescore.main()
    finally:
        sys.argv = argv
    jax_result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("thickness", "intensity"):
        np.testing.assert_allclose(result[f"mae_{name}"], jax_result[f"mae_{name}"],
                                   rtol=1e-4, atol=1e-6)


def test_conditional_mode_and_the_dci_branch(tiny, tmp_path, capsys):
    """--mode conditional edits the context of a context model; the DCI
    branch reports the JAX CLI's keys."""
    result = counterfactual_test.main(["--device", "cpu", "--preset", "morphomnist_conditional",
                                       "--mode", "conditional", "--num_samples", "4",
                                       "--batch_size", "4", "--clf_epochs", "1",
                                       "--out_dir", str(tmp_path / "cond")])
    assert set(result) == EFFECT_KEYS and all(np.isfinite(v) for v in result.values())
    result = counterfactual_test.main(["--device", "cpu", "--eval_disentanglement",
                                       "--batch_size", "256", "--out_dir", str(tmp_path / "dci")])
    assert set(result) == {"informativeness_train", "informativeness_test", "disentanglement",
                           "completeness", "IRS", "MCC_block_mean"}
    assert all(np.isfinite(v) for v in result.values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def test_nll_and_sample_clis(tiny, tmp_path, monkeypatch, capsys):
    """nll from a train CLI checkpoint: [N, T] terms and a finite positive
    bpd; sample: the npz and grid, for a model with a representation and for
    a context model without one."""
    from causaldiffae_torch import train

    monkeypatch.setattr(train, "get_config", lambda name: _tiny(name).replace(batch_size=2))
    ck = tmp_path / "ck"
    train.main(["--synthetic", "--device", "cpu", "--total_steps", "1", "--ckpt_dir", str(ck)])
    capsys.readouterr()
    total = nll.main(["--device", "cpu", "--ckpt_dir", str(ck), "--num_samples", "5",
                      "--batch_size", "4", "--out_dir", str(tmp_path / "nll")])
    assert json.loads(capsys.readouterr().out) == {"total_bpd": total}
    assert np.isfinite(total) and total > 0
    for name in ("vb", "mse", "xstart_mse"):
        with np.load(tmp_path / "nll" / f"{name}_terms.npz") as z:
            assert z["arr_0"].shape == (8, 8) and np.isfinite(z["arr_0"]).all()
    with pytest.raises(SystemExit, match="trained as morphomnist_causaldae"):
        nll.main(["--device", "cpu", "--ckpt_dir", str(ck), "--preset", "circuit_causaldae"])

    for preset, shape in (("morphomnist_causaldae", (5, 28, 28, 1)),
                          ("pendulum_conditional", (5, 32, 32, 4))):
        path = sample.main(["--device", "cpu", "--preset", preset, "--num_samples", "5",
                            "--batch_size", "4", "--sampler", "dpm++", "--sample_steps", "2",
                            "--out_dir", str(tmp_path / preset)])
        line = json.loads(capsys.readouterr().out)
        assert line == {"path": path, "shape": list(shape), "finite": True}
        with np.load(path) as z:
            np.testing.assert_array_equal(_read_png(tmp_path / preset / "grid.png"),
                                          _grid(z["arr_0"]))


def test_classifier_train_ensemble_and_rescore_columns(tiny, tmp_path, capsys):
    clf = tmp_path / "clf"
    paths = classifier_train.main(["--dataset", "morphomnist", "--factor", "-1", "--seeds",
                                   "0", "1", "--epochs", "1", "--pool", "64", "--synthetic",
                                   "--out_dir", str(clf), "--device", "cpu"])
    assert sorted(Path(p).name for p in paths) == sorted(p.name for p in clf.iterdir()) == [
        "classifier_morphomnist_intensity_seed0.pkl", "classifier_morphomnist_intensity_seed1.pkl",
        "classifier_morphomnist_thickness_seed0.pkl", "classifier_morphomnist_thickness_seed1.pkl"]
    run = tmp_path / "run"
    run.mkdir()
    rng = np.random.RandomState(0)
    for name in ("thickness", "intensity"):
        np.savez(run / f"samples_do_{name}.npz", samples=rng.rand(8, 28, 28, 1).astype(np.float32),
                 seed=0, batch_size=4, num_samples=8, process_count=1, synthetic_pool=1)
    (result,) = rescore_counterfactuals.main(
        ["--preset", "morphomnist_causaldae", "--classifier_dir", str(clf), "--runs", str(run),
         "--num_samples", "8", "--batch_size", "4", "--device", "cpu"])
    for name in ("thickness", "intensity"):
        per = result[f"mae_{name}_probes"]
        assert set(per) == {"0", "1"}
        assert result[f"mae_{name}"] == pytest.approx(np.mean(list(per.values())))
        assert result[f"mae_{name}_spread"] == pytest.approx(max(per.values()) - min(per.values()))


@pytest.mark.parametrize("bad", [dict(seed=1), dict(batch_size=8), dict(num_samples=4),
                                 dict(process_count=2), dict(synthetic_pool=0), dict(rows=4)])
def test_replay_stamps_refused_as_the_jax_cli_refuses(tmp_path, bad):
    sys.path.insert(0, SCRIPTS)
    from rescore_counterfactuals import check_replay_stamps as jax_check

    stamps = dict(seed=0, batch_size=4, num_samples=8, process_count=1, synthetic_pool=1)
    rows = bad.pop("rows", 8)
    np.savez(tmp_path / "a.npz", samples=np.zeros((rows, 2, 2, 1)), **{**stamps, **bad})
    kw = dict(seed=0, batch_size=4, num_samples=8, n_rows_expected=8)
    for check in (jax_check, rescore_counterfactuals.check_replay_stamps):
        with np.load(tmp_path / "a.npz") as archive, pytest.raises(SystemExit):
            check(archive, "a.npz", **kw)
    np.savez(tmp_path / "ok.npz", samples=np.zeros((8, 2, 2, 1)))   # unstamped passes
    with np.load(tmp_path / "ok.npz") as archive:
        rescore_counterfactuals.check_replay_stamps(archive, "ok.npz", **kw)


def test_the_clis_refuse_what_they_cannot_do(tmp_path):
    import torch.distributed as dist

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            counterfactual_test.main(["--out_dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        counterfactual_test.parse_args(["--sampler", "ddim", "--sample_steps", "5"])
    with pytest.raises(SystemExit):
        sample.parse_args(["--sample_steps", "5"])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(SystemExit, match="single-process"):
            nll.main(["--device", "cpu"])
    finally:
        dist.destroy_process_group()
