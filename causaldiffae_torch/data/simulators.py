"""Ground-truth SCM and renderer for synthetic MorphoMNIST.

The port's own copy of the morphomnist subset of
``causaldiffae_tpu/data/simulators.py:49-55,122-130`` (the JAX package's
module sits behind an import chain that reaches JAX). Thickness drives
intensity through the saturating response ``i = 191 sigmoid(2 t - 5) + 64``
(plus noise); the renderer draws a Gaussian ring whose stroke width follows
the thickness and whose peak follows the intensity, so both factors are
visible in the image.
"""

from __future__ import annotations

import numpy as np

__all__ = ["morphomnist_scm", "render_morphomnist"]


def morphomnist_scm(thickness: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """intensity = f(thickness) + noise."""
    t = np.asarray(thickness, dtype=np.float64)
    return 191.0 / (1.0 + np.exp(-(2.0 * t - 5.0))) + 64.0 + noise


def render_morphomnist(thickness, intensity, size: int) -> np.ndarray:
    """Digit-like Gaussian ring, [N, size, size, 1] float32 in [0, 1]."""
    t = np.asarray(thickness, dtype=np.float64).reshape(-1, 1, 1)
    i = np.asarray(intensity, dtype=np.float64).reshape(-1, 1, 1)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    r = np.sqrt((xx - size / 2 + 0.5) ** 2 + (yy - size / 2 + 0.5) ** 2)
    ring = np.exp(-((r[None] - size * 0.28) ** 2) / (2.0 * np.maximum(t / 2.0, 0.3) ** 2))
    img = (i / 255.0) * ring
    return np.clip(img, 0.0, 1.0)[..., None].astype(np.float32)
