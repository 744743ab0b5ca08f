"""Image quality: Frechet distance machinery and FID.

Port of ``causaldiffae_tpu/evals/quality.py``: activation statistics
(mu, sigma) and the matrix-square-root Frechet distance (numpy/scipy, the
same code, so the same features give bit-equal distances), with pluggable
features: InceptionV3's pool features from a local weights file
(``evals.inception``), else the trunk of a trained anti-causal probe
(``GaussianConvEncoderClf.features``, the JAX package's default when no
Inception weights are given), else average-pooled pixels.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

__all__ = ["activation_statistics", "frechet_distance", "FID", "pixel_feature_fn",
           "classifier_feature_fn", "inception_feature_fn", "default_feature_fn"]


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) over [N, D] features (reference `quality_metrics.py:9-43`)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (reference `:45-73`)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def pixel_feature_fn(size: int = 8) -> Callable[[np.ndarray], np.ndarray]:
    """Cheap always-available features: avg-pooled grayscale pixels."""
    def fn(images: np.ndarray) -> np.ndarray:
        x = np.asarray(images, dtype=np.float64)
        if x.ndim == 4:
            x = x.mean(axis=-1)
        B, H, W = x.shape
        fh, fw = H // size, W // size
        x = x[:, : fh * size, : fw * size]
        x = x.reshape(B, size, fh, size, fw).mean(axis=(2, 4))
        return x.reshape(B, -1)
    return fn


def classifier_feature_fn(model, batch_size: int = 64) -> Callable[[np.ndarray], np.ndarray]:
    """A trained probe's trunk activations (float32, the JAX package's (H, W, C)
    order), computed on the probe's device in eval mode."""
    device = next(model.parameters()).device
    model.eval()

    @torch.inference_mode()
    def fn(images: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(np.asarray(images[i:i + batch_size], np.float32)).to(device)
            out.append(model.features(x).cpu().numpy())
        return np.concatenate(out, axis=0)

    return fn


def inception_feature_fn(weights_path: Optional[str] = None, batch_size: int = 32,
                         feature: int = 64, device="cpu") -> Callable[[np.ndarray], np.ndarray]:
    """InceptionV3 pool features, the published-FID feature space, from a
    local weights file; raises without one (random-init features would give
    a meaningless FID)."""
    if not weights_path:
        raise RuntimeError(
            "inception FID needs a local weights file (no download); random-init features "
            "would give a meaningless FID. Use classifier_feature_fn instead.")
    from .inception import head_feature_fn, load_inception_head

    return head_feature_fn(load_inception_head(weights_path, feature, device),
                           batch_size=batch_size, device=device)


def default_feature_fn(classifier_model=None, inception_weights: Optional[str] = None,
                       device="cpu"):
    """Best-available feature extractor: Inception (local weights) > probe
    trunk > avg-pooled pixels."""
    if inception_weights:
        return inception_feature_fn(inception_weights, device=device)
    if classifier_model is not None:
        return classifier_feature_fn(classifier_model)
    return pixel_feature_fn()


class FID:
    """Accumulate real/fake features, then compute the Frechet distance
    (reference `quality_metrics.py:75-83`)."""

    def __init__(self, feature_fn: Optional[Callable] = None):
        self.feature_fn = feature_fn or pixel_feature_fn()
        self._real = []
        self._fake = []

    def update(self, images: np.ndarray, real: bool):
        feats = self.feature_fn(images)
        (self._real if real else self._fake).append(np.asarray(feats))

    def compute(self) -> float:
        real = np.concatenate(self._real, axis=0)
        fake = np.concatenate(self._fake, axis=0)
        mu1, s1 = activation_statistics(real)
        mu2, s2 = activation_statistics(fake)
        return frechet_distance(mu1, s1, mu2, s2)

    def reset(self):
        self._real, self._fake = [], []
