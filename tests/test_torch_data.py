"""The port's data modules against the JAX package's, bit for bit.

- the SCM simulators and renderers (``data/simulators.py``);
- the synthetic pools of all three datasets and their batch iterator, with
  their key sets (pendulum and circuit carry no class labels);
- the IDX codec, and every real-data loader on tiny fixture files written
  to ``tmp_path`` in the datasets' own formats: MorphoMNIST IDX + CSV,
  Pendulum PNGs, CausalCircuit ``.npz`` with and without ``simplified``, an
  image folder;
- ``load_data``'s dispatch and ``batch_iterator`` (shuffled, in order, with
  and without ``drop_last``) giving the same batches.

Inputs are made with numpy from a seed; the JAX package's iterators run on
their numpy path (``native=False``).
"""

import io

import numpy as np
import pytest

from causaldiffae_tpu.data import loaders as jl
from causaldiffae_tpu.data import simulators as js
from causaldiffae_tpu.data import synthetic as jsyn
from causaldiffae_torch.data import loaders as tl
from causaldiffae_torch.data import simulators as ts
from causaldiffae_torch.data import synthetic as tsyn

SIZES = {"morphomnist": 28, "pendulum": 24, "circuit": 32}


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_simulators_match_jax():
    rng = np.random.RandomState(0)
    angle, light = rng.uniform(-40, 44, 5), rng.uniform(60, 148, 5)
    for a, b in zip(ts.pendulum_scm(angle, light), js.pendulum_scm(angle, light)):
        np.testing.assert_array_equal(a, b)
    arm = rng.uniform(0, 1, 6)
    np.testing.assert_array_equal(ts.circuit_scm(arm), js.circuit_scm(arm))
    np.testing.assert_array_equal(ts.circuit_scm(arm, np.random.RandomState(1)),
                                  js.circuit_scm(arm, np.random.RandomState(1)))
    t = rng.uniform(0.7, 5.8, 4)
    noise = rng.randn(4)
    np.testing.assert_array_equal(ts.morphomnist_scm(t, noise), js.morphomnist_scm(t, noise))
    np.testing.assert_array_equal(ts.morphomnist_generate(t), js.morphomnist_generate(t))
    for a, b in zip(ts.pendulum_generate(angle[:2], light[:2]),
                    js.pendulum_generate(angle[:2], light[:2])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.render_morphomnist(t, 200 + t, size=20),
                                  js.render_morphomnist(t, 200 + t, size=20))
    np.testing.assert_array_equal(ts.render_pendulum(angle, light, size=24),
                                  js.render_pendulum(angle, light, size=24))
    cols = rng.uniform(0, 1, (3, 6))
    np.testing.assert_array_equal(ts.render_circuit(arm, *cols, size=32),
                                  js.render_circuit(arm, *cols, size=32))


@pytest.mark.parametrize("dataset", ["morphomnist", "pendulum", "circuit"])
def test_synthetic_pool_and_iterator_match_jax(dataset):
    size = SIZES[dataset]
    got = tsyn.synthetic_dataset(dataset, 12, seed=3, image_size=size)
    want = jsyn.synthetic_dataset(dataset, 12, seed=3, image_size=size)
    _equal(got, want)
    assert ("y" in got) == (dataset == "morphomnist")
    assert float(np.abs(np.rint(got["image"] * 255) - got["image"] * 255).max()) < 1e-4
    it = tsyn.synthetic_iterator(dataset, 4, seed=5, image_size=size)
    jit_ = jsyn.synthetic_iterator(dataset, 4, seed=5, image_size=size, native=False,
                                   shard=False)
    for _ in range(3):
        _equal(next(it), next(jit_))


def test_unknown_synthetic_dataset_raises():
    with pytest.raises(ValueError):
        tsyn.synthetic_dataset("celeba", 2)


def test_idx_codec_matches_jax(tmp_path):
    for dtype in (np.uint8, np.int32, np.float32):
        arr = (np.arange(2 * 3 * 5) % 200).astype(dtype).reshape(2, 3, 5)
        tl.save_idx(arr, str(tmp_path / "a.gz"))
        jl.save_idx(arr, str(tmp_path / "b.gz"))
        for p in ("a.gz", "b.gz"):
            np.testing.assert_array_equal(tl.load_idx(str(tmp_path / p)), arr)
            np.testing.assert_array_equal(jl.load_idx(str(tmp_path / p)), arr)
    (tmp_path / "bad").write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x01\x00")
    with pytest.raises(ValueError):
        tl.load_idx(str(tmp_path / "bad"))


# --------------------------------------------------------------------- #
# tiny datasets in their own on-disk formats
# --------------------------------------------------------------------- #
def _image_module():
    pytest.importorskip("PIL")
    from PIL import Image

    return Image


@pytest.fixture
def morphomnist_dir(tmp_path):
    pytest.importorskip("pandas")
    d = tmp_path / "morphomnist_data"
    d.mkdir()
    rng = np.random.RandomState(0)
    n = 10
    for prefix in ("train", "t10k"):
        jl.save_idx(rng.randint(0, 256, size=(n, 28, 28)).astype(np.uint8),
                    str(d / f"{prefix}-images-idx3-ubyte.gz"))
        jl.save_idx(rng.randint(0, 10, size=(n,)).astype(np.uint8),
                    str(d / f"{prefix}-labels-idx1-ubyte.gz"))
        rows = ["index,area,length,thickness,slant,width,height,intensity"]
        rows += [f"{i},10,20,{rng.uniform(1, 5):.4f},0,5,5,{rng.uniform(70, 250):.3f}"
                 for i in range(n)]
        (d / f"{prefix}-morpho.csv").write_text("\n".join(rows))
    return str(d)


@pytest.fixture
def pendulum_dir(tmp_path):
    Image = _image_module()
    d = tmp_path / "pendulum"
    rng = np.random.RandomState(1)
    for split in ("train", "test"):
        (d / split).mkdir(parents=True)
        for i in range(7):
            arr = rng.randint(0, 256, size=(96, 96, 4)).astype(np.uint8)
            Image.fromarray(arr, "RGBA").save(d / split / f"a_{i * 5 - 20}_{90 + i}_{6}_{12}.png")
        (d / split / "notes.txt").write_text("not an image")
    return str(d)


@pytest.fixture
def circuit_dir(tmp_path):
    Image = _image_module()
    d = tmp_path / "causal_circuit"
    d.mkdir()
    rng = np.random.RandomState(2)
    # raw order [red, green, blue, arm]: one row in each 'simplified' regime
    regimes = np.array([[0.8, 0.6, 0.1, 0.25], [0.8, 0.1, 0.1, 0.5], [0.8, 0.1, 0.6, 0.8]])
    for name in [f"train-{k}.npz" for k in range(5)] + ["test.npz"]:
        n = 3
        imgs = np.empty((n, 2), dtype=object)
        for i in range(n):
            for f in range(2):
                buf = io.BytesIO()
                Image.fromarray(rng.randint(0, 256, size=(48, 64, 3)).astype(np.uint8)).save(
                    buf, format="PNG")
                imgs[i, f] = buf.getvalue()
        lat = rng.rand(n, 2, 4)
        lat[rng.randint(n), rng.randint(2)] = regimes[rng.randint(3)]
        np.savez(d / name, imgs=imgs, original_latents=lat)
    return str(d)


@pytest.fixture
def folder_dir(tmp_path):
    Image = _image_module()
    d = tmp_path / "faces"
    (d / "sub").mkdir(parents=True)
    rng = np.random.RandomState(3)
    for name, (w, h) in [("cat_1.png", (70, 50)), ("dog_2.jpg", (33, 40)),
                         ("sub/cat_3.png", (140, 90)), ("dog_4.gif", (32, 32))]:
        Image.fromarray(rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)).save(d / name)
    return str(d)


def test_morphomnist_loader_matches_jax(morphomnist_dir):
    for train in (True, False):
        _equal(tl.load_morphomnist(morphomnist_dir, train=train),
               jl.load_morphomnist(morphomnist_dir, train=train))


def test_pendulum_loader_matches_jax(pendulum_dir):
    for split in ("train", "test"):
        _equal(tl.load_pendulum(pendulum_dir, split), jl.load_pendulum(pendulum_dir, split))


@pytest.mark.parametrize("simplified", [False, True], ids=["all", "simplified"])
def test_circuit_loader_matches_jax(circuit_dir, simplified):
    got = tl.load_circuit(circuit_dir, "train", image_size=32, simplified=simplified)
    want = jl.load_circuit(circuit_dir, "train", image_size=32, simplified=simplified)
    _equal(got, want)
    assert got["image"].shape[1:] == (32, 42, 3)  # smaller edge to 32, the other truncated
    if simplified:
        assert 5 <= len(got["c"]) < 30
    _equal(tl.load_circuit(circuit_dir, "test", image_size=48),
           jl.load_circuit(circuit_dir, "test", image_size=48))


def test_image_folder_loader_matches_jax(folder_dir):
    for class_cond in (False, True):
        _equal(tl.load_image_folder(folder_dir, 16, class_cond=class_cond),
               jl.load_image_folder(folder_dir, 16, class_cond=class_cond))


def test_load_data_dispatch_matches_jax(morphomnist_dir, pendulum_dir, circuit_dir, folder_dir):
    for root, size, keys in ((morphomnist_dir, 28, {"image", "y", "c"}),
                             (pendulum_dir, 96, {"image", "c"}),
                             (circuit_dir, 32, {"image", "c"}),
                             (folder_dir, 16, {"image", "y"})):
        kw = dict(data_dir=root, batch_size=3, image_size=size, class_cond=True, seed=4)
        got, want = tl.load_data(native=False, **kw), jl.load_data(native=False, **kw)
        for _ in range(3):
            batch = next(got)
            assert set(batch) == keys
            _equal(batch, next(want))
    with pytest.raises(ValueError):
        tl.load_data(data_dir="", batch_size=2, image_size=28)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (False, False),
                                               (True, False)])
def test_batch_iterator_matches_jax(shuffle, drop_last):
    rng = np.random.RandomState(5)
    data = {"image": rng.rand(7, 2, 2, 1).astype(np.float32), "c": rng.rand(7, 2)}
    got = tl.batch_iterator(data, 3, seed=6, shuffle=shuffle, drop_last=drop_last)
    want = jl.batch_iterator(data, 3, seed=6, shuffle=shuffle, drop_last=drop_last)
    sizes = []
    for _ in range(6):
        batch = next(got)
        sizes.append(len(batch["image"]))
        _equal(batch, next(want))
    assert sizes == ([3, 3] * 3 if drop_last else [3, 3, 1] * 2)
