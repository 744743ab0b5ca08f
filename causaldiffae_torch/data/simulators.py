"""Ground-truth SCM simulators + synthetic renderers.

The port's own copy of ``causaldiffae_tpu/data/simulators.py`` (numpy, the
same arithmetic; the JAX package's module sits behind an import chain that
reaches JAX). The models:

- MorphoMNIST SCM: thickness -> intensity via the saturating response
  i = 191 * sigmoid(2 t - 5) + 64 (maps t in [0.5, 5.5] onto i in [64, 255],
  consistent with the dataset normalization scale {'thickness': [3.4, 2.4],
  'intensity': [161, 94]}, `image_datasets.py:266`).
- Pendulum SCM: (angle, light) -> (shadow_len, shadow_pos) by point-light
  projection: pivot at (10, 10.5), rod length 9.5, light at height 20.5 with
  horizontal position 10 + 10/tan(phi), shadow = projection of rod endpoints
  onto the ground. Angle/light in the dataset's integer units ([-40, 44] and
  [60, 148], converted by pi/200), matching the label scales
  [[2,42],[104,44],[7.5,4.5],[11,8]] (`image_datasets.py:360`).
- CausalCircuit SCM: arm -> {blue, green} and (arm, blue, green) -> red,
  all in [0, 1] (latent order [arm, blue, green, red] after the reference's
  [3,2,1,0] permutation, `image_datasets.py:455-459`).

The renderers draw images whose features are *actually controlled* by the
labels, so anti-causal classifiers can regress the factors and effectiveness
MAE is meaningful end-to-end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "morphomnist_scm",
    "pendulum_scm",
    "circuit_scm",
    "render_morphomnist",
    "render_pendulum",
    "render_circuit",
    "morphomnist_generate",
    "pendulum_generate",
]


# --------------------------------------------------------------------- #
# SCM mechanisms
# --------------------------------------------------------------------- #
def morphomnist_scm(thickness: np.ndarray, noise: Optional[np.ndarray] = None) -> np.ndarray:
    """intensity = f(thickness) + noise."""
    t = np.asarray(thickness, dtype=np.float64)
    i = 191.0 / (1.0 + np.exp(-(2.0 * t - 5.0))) + 64.0
    if noise is not None:
        i = i + noise
    return i


def pendulum_scm(angle: np.ndarray, light: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(shadow_len, shadow_pos) from (angle, light) in dataset units."""
    theta = np.asarray(angle, dtype=np.float64) * np.pi / 200.0
    phi = np.asarray(light, dtype=np.float64) * np.pi / 200.0
    pivot = np.array([10.0, 10.5])
    rod = 9.5
    ball = np.stack([pivot[0] + rod * np.sin(theta), pivot[1] - rod * np.cos(theta)], -1)
    y_l = 20.5
    x_l = 10.0 + 10.0 / np.tan(phi)

    def ground_proj(pt):
        # project point pt from light (x_l, y_l) onto the ground y=0
        return x_l + (pt[..., 0] - x_l) * y_l / (y_l - pt[..., 1])

    s_ball = ground_proj(ball)
    s_pivot = x_l + (pivot[0] - x_l) * y_l / (y_l - pivot[1])
    shadow_len = np.abs(s_ball - s_pivot)
    shadow_pos = 0.5 * (s_ball + s_pivot)
    return shadow_len, shadow_pos


def circuit_scm(arm: np.ndarray, rng: Optional[np.random.RandomState] = None):
    """blue = s(arm near .25), green = s(arm near .75), red = blue*green cap."""
    a = np.asarray(arm, dtype=np.float64)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    blue = sig(12.0 * (a - 0.25))
    green = sig(12.0 * (a - 0.75))
    red = sig(6.0 * (a + blue + green - 1.5))
    if rng is not None:
        blue = np.clip(blue + rng.randn(*np.shape(a)) * 0.02, 0, 1)
        green = np.clip(green + rng.randn(*np.shape(a)) * 0.02, 0, 1)
        red = np.clip(red + rng.randn(*np.shape(a)) * 0.02, 0, 1)
    return blue, green, red


# --------------------------------------------------------------------- #
# `datasets.generators` API equivalents used by the eval harness
# --------------------------------------------------------------------- #
def morphomnist_generate(thickness, intensity=None):
    """Counterfactual ground truth: given do(thickness), recompute intensity.

    Returns v with columns [thickness, intensity] (the reference calls
    `ms.generate(thickness=..., intensity=...)` and reads columns,
    `image_causaldae_test.py:353-357`).
    """
    t = np.asarray(thickness, dtype=np.float64)
    i = morphomnist_scm(t)
    return np.stack([t, i], axis=-1)


def pendulum_generate(angle, light):
    """Counterfactual ground truth: (X_real, v) with v=[angle, light, len, pos]
    (reference usage `image_causaldae_test.py:556-607`)."""
    a = np.asarray(angle, dtype=np.float64)
    l = np.asarray(light, dtype=np.float64)
    slen, spos = pendulum_scm(a, l)
    v = np.stack([a, l, slen, spos], axis=-1)
    x = render_pendulum(a, l)
    return x, v


# --------------------------------------------------------------------- #
# Renderers (vectorized numpy, HWC float32 in [0, 1])
# --------------------------------------------------------------------- #
def render_morphomnist(thickness, intensity, size: int = 28) -> np.ndarray:
    """Digit-like Gaussian ring: stroke width ~ thickness, peak ~ intensity."""
    t = np.asarray(thickness, dtype=np.float64).reshape(-1, 1, 1)
    i = np.asarray(intensity, dtype=np.float64).reshape(-1, 1, 1)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    r = np.sqrt((xx - size / 2 + 0.5) ** 2 + (yy - size / 2 + 0.5) ** 2)
    ring = np.exp(-((r[None] - size * 0.28) ** 2) / (2.0 * np.maximum(t / 2.0, 0.3) ** 2))
    img = (i / 255.0) * ring
    return np.clip(img, 0.0, 1.0)[..., None].astype(np.float32)


def render_pendulum(angle, light, size: int = 96) -> np.ndarray:
    """96x96 RGBA scene: rod+ball, sun, and the projected shadow bar."""
    a = np.atleast_1d(np.asarray(angle, dtype=np.float64))
    l = np.atleast_1d(np.asarray(light, dtype=np.float64))
    B = a.shape[0]
    slen, spos = pendulum_scm(a, l)
    theta = a * np.pi / 200.0
    phi = l * np.pi / 200.0

    # scene coords: x in [0, 20], y in [0, 21]; map to pixels
    sx = size / 20.0
    sy = size / 21.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    wx = xx / sx                       # world x
    wy = (size - 1 - yy) / sy          # world y (up)

    img = np.zeros((B, size, size, 4), dtype=np.float64)
    img[..., 3] = 1.0

    pivot = np.array([10.0, 10.5])
    ballx = pivot[0] + 9.5 * np.sin(theta)
    bally = pivot[1] - 9.5 * np.cos(theta)
    lightx = 10.0 + 10.0 / np.tan(phi)

    for b in range(B):
        # rod: distance from segment pivot->ball
        px, py = pivot
        bx, by = ballx[b], bally[b]
        vx, vy = bx - px, by - py
        L2 = vx * vx + vy * vy
        tt = np.clip(((wx - px) * vx + (wy - py) * vy) / L2, 0, 1)
        d = np.sqrt((wx - (px + tt * vx)) ** 2 + (wy - (py + tt * vy)) ** 2)
        rod = np.exp(-(d**2) / (2 * 0.25**2))
        img[b, ..., 0] += 0.55 * rod
        img[b, ..., 1] += 0.27 * rod
        # ball
        db = np.sqrt((wx - bx) ** 2 + (wy - by) ** 2)
        ball = np.exp(-(db**2) / (2 * 0.8**2))
        img[b, ..., 0] += 0.9 * ball
        # sun
        ds = np.sqrt((wx - np.clip(lightx[b], -5, 25)) ** 2 + (wy - 19.5) ** 2)
        sun = np.exp(-(ds**2) / (2 * 1.2**2))
        img[b, ..., 0] += sun
        img[b, ..., 1] += 0.8 * sun
        # shadow bar on the ground (y ~ 0.6)
        half = slen[b] / 2.0
        in_bar = np.exp(-((wy - 0.8) ** 2) / (2 * 0.4**2)) * (
            1.0 / (1.0 + np.exp(-4 * (half - np.abs(wx - spos[b]))))
        )
        img[b, ..., 0] += 0.35 * in_bar
        img[b, ..., 1] += 0.35 * in_bar
        img[b, ..., 2] += 0.35 * in_bar
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_circuit(arm, blue, green, red, size: int = 128) -> np.ndarray:
    """128x128 RGB: arm slider position + three colored lamps."""
    a = np.atleast_1d(np.asarray(arm, dtype=np.float64))
    B = a.shape[0]
    cols = np.stack(
        [np.atleast_1d(np.asarray(c, dtype=np.float64)) for c in (blue, green, red)], -1
    )
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / (size - 1)
    img = np.zeros((B, size, size, 3), dtype=np.float64)
    lamp_x = [0.25, 0.5, 0.75]
    lamp_rgb = [(0.1, 0.2, 1.0), (0.1, 1.0, 0.2), (1.0, 0.15, 0.1)]
    for b in range(B):
        # arm: bright vertical bar at x = arm
        bar = np.exp(-((xx - a[b]) ** 2) / (2 * 0.02**2)) * (yy > 0.6)
        for ch in range(3):
            img[b, ..., ch] += 0.8 * bar
        for i, (lx, rgb) in enumerate(zip(lamp_x, lamp_rgb)):
            d = (xx - lx) ** 2 + (yy - 0.3) ** 2
            lamp = np.exp(-d / (2 * 0.05**2)) * cols[b, i]
            for ch in range(3):
                img[b, ..., ch] += rgb[ch] * lamp
    return np.clip(img, 0.0, 1.0).astype(np.float32)
