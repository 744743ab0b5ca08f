"""The synthetic MorphoMNIST pool and its shuffled batch iterator.

The port's own copy of the morphomnist subset of
``causaldiffae_tpu/data/synthetic.py:31-65`` and of the numpy
``batch_iterator`` (``data/loaders.py:200-210``) that the JAX package's
``make_data_iterator`` falls back to. Batches are the trainer's format,
NHWC as the JAX package feeds them: {'image': [B, H, W, 1] float32 in
[0, 1] on the 8-bit grid, 'y': [B] int64, 'c': [B, 2] float32 normalised
labels}. The other datasets and the real-data loaders are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..config import DATA_SCALES
from .simulators import morphomnist_scm, render_morphomnist

__all__ = ["synthetic_dataset", "batch_iterator", "synthetic_iterator"]

POOL = 4096  # samples in the training pool, as the JAX package's default


def _normalize(c_raw: np.ndarray, dataset: str) -> np.ndarray:
    scale = np.asarray(DATA_SCALES[dataset])
    return ((c_raw - scale[:, 0]) / scale[:, 1]).astype(np.float32)


def _quantize8(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Snap rendered images onto the 8-bit grid (u8 / 255), as real sources are."""
    img = data["image"]
    data["image"] = (np.rint(img * 255.0).astype(np.uint8).astype(np.float32)
                     / np.float32(255.0))
    return data


def synthetic_dataset(dataset: str, n: int, seed: int = 0,
                      image_size: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``n`` samples of the synthetic workload, made from ``seed``."""
    if dataset != "morphomnist":
        raise NotImplementedError(f"synthetic {dataset!r} is not ported yet (morphomnist is)")
    rng = np.random.RandomState(seed)
    thickness = rng.uniform(0.7, 5.8, size=n)
    intensity = morphomnist_scm(thickness, noise=rng.randn(n) * 4.0)
    images = render_morphomnist(thickness, intensity, size=image_size or 28)
    c = _normalize(np.stack([thickness, intensity], -1), dataset)
    y = rng.randint(0, 10, size=n).astype(np.int64)
    return _quantize8({"image": images, "y": y, "c": c})


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite epoch-shuffled batch iterator; drops each epoch's partial batch."""
    n = len(data["image"])
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.permutation(n)
        for i in range(0, (n // batch_size) * batch_size, batch_size):
            sel = idx[i:i + batch_size]
            yield {k: v[sel] for k, v in data.items()}


def synthetic_iterator(dataset: str, batch_size: int, seed: int = 0,
                       image_size: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled batches over a fixed synthetic pool of ``POOL`` samples."""
    data = synthetic_dataset(dataset, POOL, seed=seed, image_size=image_size)
    return batch_iterator(data, batch_size, seed=seed + 1)
