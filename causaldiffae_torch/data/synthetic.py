"""Synthetic datasets from the ground-truth SCMs, and their batch iterator.

The port's own copy of ``causaldiffae_tpu/data/synthetic.py:31-110``: sample
the exogenous factors, push them through the SCMs of ``simulators.py``,
render, and snap the images onto the 8-bit grid. Batches are the trainer's
format, NHWC as the JAX package feeds them: {'image': [B, H, W, C] float32
in [0, 1], 'c': [B, n_vars] float32 normalised labels, and for MorphoMNIST
'y': [B] int64}. Pendulum and CausalCircuit have no class labels.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..config import DATA_SCALES
from .loaders import batch_iterator, rank_shard
from .simulators import (
    circuit_scm,
    morphomnist_scm,
    pendulum_scm,
    render_circuit,
    render_morphomnist,
    render_pendulum,
)

__all__ = ["synthetic_dataset", "synthetic_iterator"]

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
    rng = np.random.RandomState(seed)
    if dataset == "morphomnist":
        thickness = rng.uniform(0.7, 5.8, size=n)
        intensity = morphomnist_scm(thickness, noise=rng.randn(n) * 4.0)
        images = render_morphomnist(thickness, intensity, size=image_size or 28)
        c = _normalize(np.stack([thickness, intensity], -1), dataset)
        y = rng.randint(0, 10, size=n).astype(np.int64)
        return _quantize8({"image": images, "y": y, "c": c})
    if dataset == "pendulum":
        angle = rng.uniform(-40, 44, size=n)
        light = rng.uniform(60, 148, size=n)
        light = np.where(np.abs(light - 100) < 1e-3, 101.0, light)  # tan(pi/2) pole
        slen, spos = pendulum_scm(angle, light)
        images = render_pendulum(angle, light, size=image_size or 96)
        c = _normalize(np.stack([angle, light, slen, spos], -1), dataset)
        return _quantize8({"image": images, "c": c.astype(np.float32)})
    if dataset == "circuit":
        arm = rng.uniform(0, 1, size=n)
        blue, green, red = circuit_scm(arm, rng)
        images = render_circuit(arm, blue, green, red, size=image_size or 128)
        c = np.stack([arm, blue, green, red], -1).astype(np.float32)
        return _quantize8({"image": images, "c": c})
    raise ValueError(f"unknown synthetic dataset: {dataset}")


def synthetic_iterator(dataset: str, batch_size: int, seed: int = 0,
                       image_size: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled batches over a fixed synthetic pool of ``POOL`` samples; under
    data parallelism this rank's ``[rank::W]`` slice of the pool and its
    ``batch_size / W`` rows of the global ``batch_size`` per batch
    (``causaldiffae_tpu/data/synthetic.py:99-109``)."""
    data = synthetic_dataset(dataset, POOL, seed=seed, image_size=image_size)
    return batch_iterator(*rank_shard(data, batch_size), seed=seed + 1)
