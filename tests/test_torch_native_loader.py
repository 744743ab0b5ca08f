"""The port's native C++ loader (``causaldiffae_torch/data/native_loader.py``)
on the cases of ``tests/test_native_loader.py``, and against the JAX
package's loader: the same source, so the same batches for the same seed and
pool, bit for bit."""

import gzip

import numpy as np
import pytest

from causaldiffae_tpu.data.native_loader import NativeBatchIterator as JaxNativeBatchIterator
from causaldiffae_torch.data import loaders
from causaldiffae_torch.data.native_loader import (NativeBatchIterator, gather_normalize,
                                                   gunzip_file, native_available)


@pytest.fixture(autouse=True)
def _needs_native():
    """Decided when a test runs, not at import: g++ and zlib build the loader."""
    if not native_available():
        pytest.skip("g++/zlib unavailable: the native loader does not build")


def test_gunzip_matches_python(tmp_path):
    payload = bytes(range(256)) * 1000
    p = tmp_path / "x.gz"
    with gzip.open(p, "wb") as f:
        f.write(payload)
    assert gunzip_file(str(p)) == payload


def test_gather_normalize_matches_numpy():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, size=(100, 7, 7, 3), dtype=np.uint8)
    idx = rng.randint(0, 100, size=32).astype(np.int64)
    got = gather_normalize(images, idx, scale=1.0 / 255.0, offset=0.0, threads=3)
    np.testing.assert_allclose(got, images[idx].astype(np.float32) / 255.0, atol=1e-7)
    got2 = gather_normalize(images, idx, scale=1.0 / 127.5, offset=-1.0)
    np.testing.assert_allclose(got2, images[idx].astype(np.float32) / 127.5 - 1.0, atol=1e-6)


def test_prefetch_iterator_batches():
    rng = np.random.RandomState(1)
    n = 64
    images = rng.randint(0, 256, size=(n, 5, 5, 1), dtype=np.uint8)
    c = rng.rand(n, 2).astype(np.float32)
    y = rng.randint(0, 10, size=n).astype(np.int64)
    it = NativeBatchIterator(images, batch_size=16, c=c, y=y, seed=0, threads=2)
    flat = images.reshape(n, -1).astype(np.float32) / 255.0
    seen = []
    for _ in range(8):  # 2 epochs
        b = next(it)
        assert b["image"].shape == (16, 5, 5, 1) and b["image"].dtype == np.float32
        assert b["c"].shape == (16, 2) and b["y"].shape == (16,)
        assert b["image"].min() >= 0.0 and b["image"].max() <= 1.0
        for row in b["image"].reshape(16, -1):   # every row is a real sample
            assert np.abs(flat - row).sum(axis=1).min() < 1e-5
        seen.append(b["image"].sum())
    it.close()
    assert len({round(float(s), 3) for s in seen}) > 1   # shuffled


@pytest.mark.parametrize("with_labels", [True, False], ids=["labels", "images_only"])
def test_batches_equal_the_jax_loader(with_labels):
    """The port's copy of fastloader.cpp gives the JAX loader's batches for
    the same pool, seed and threads, over two epochs."""
    rng = np.random.RandomState(2)
    n = 48
    images = rng.randint(0, 256, size=(n, 6, 6, 2), dtype=np.uint8)
    extra = dict(c=rng.rand(n, 3).astype(np.float32),
                 y=rng.randint(0, 10, size=n).astype(np.int64)) if with_labels else {}
    ours = NativeBatchIterator(images, 8, seed=7, threads=3, **extra)
    theirs = JaxNativeBatchIterator(images, 8, seed=7, threads=3, **extra)
    for _ in range(12):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ours.close()
    theirs.close()


def test_make_data_iterator_routes_native():
    from causaldiffae_torch.data import synthetic_dataset

    data = synthetic_dataset("morphomnist", 64, seed=0)
    it = loaders.make_data_iterator(data, 16, seed=0)
    assert isinstance(it, NativeBatchIterator)
    b = next(it)
    assert b["image"].shape == (16, 28, 28, 1) and b["image"].dtype == np.float32
    assert b["y"].shape == (16,) and b["c"].shape == (16, 2)
    flat = data["image"].reshape(64, -1)
    for row in b["image"].reshape(16, -1)[:4]:   # the pool's values, from uint8
        assert np.abs(flat - row).sum(axis=1).min() < 1e-4
    it.close()


def test_make_data_iterator_numpy_fallbacks():
    rng = np.random.RandomState(0)
    data = {"image": rng.rand(32, 8, 8, 1).astype(np.float32)}
    assert loaders._uint8_pool(data["image"]) is None
    it = loaders.make_data_iterator(data, 8, seed=0)   # off the grid: numpy
    assert not isinstance(it, NativeBatchIterator)
    assert next(it)["image"].shape == (8, 8, 8, 1)
    with pytest.raises(ValueError):
        loaders.make_data_iterator(data, 8, native=True)
    q = (np.rint(data["image"] * 255) / np.float32(255.0)).astype(np.float32)
    it2 = loaders.make_data_iterator({"image": q}, 8, shuffle=False)   # in order: numpy
    assert not isinstance(it2, NativeBatchIterator)
    np.testing.assert_allclose(next(it2)["image"], q[:8])
    with pytest.raises(ValueError):
        loaders.make_data_iterator({"image": q}, 8, shuffle=False, native=True)


def test_uint8_pool_roundtrip_both_scalings():
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, size=(50, 4, 4, 3), dtype=np.uint8)
    for x, want in ((u8.astype(np.float32) / 255.0, (1.0 / 255.0, 0.0)),
                    (u8.astype(np.float32) / 127.5 - 1.0, (1.0 / 127.5, -1.0))):
        pool = loaders._uint8_pool(x)
        assert pool is not None
        got, scale, offset = pool
        np.testing.assert_array_equal(got, u8)
        assert (scale, offset) == want


def test_load_data_routes_by_flag(tmp_path):
    """``load_data`` serves the native loader by default on an 8-bit dataset,
    as the JAX package does, and keeps the numpy iterator with ``native=False``."""
    images = np.random.RandomState(4).randint(0, 256, size=(24, 4, 4, 3), dtype=np.uint8)
    folder = tmp_path / "imgs"
    folder.mkdir()
    pytest.importorskip("PIL")
    from PIL import Image

    for i, im in enumerate(images):
        Image.fromarray(im).save(folder / f"cls{i % 2}_{i}.png")
    kw = dict(data_dir=str(folder), batch_size=4, image_size=4)
    assert not isinstance(loaders.load_data(native=False, **kw), NativeBatchIterator)
    it = loaders.load_data(**kw)
    assert isinstance(it, NativeBatchIterator)
    assert next(it)["image"].shape == (4, 4, 4, 3)
    it.close()
