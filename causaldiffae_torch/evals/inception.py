"""InceptionV3 feature head for published-comparable FID.

Port of ``causaldiffae_tpu/evals/inception.py``: the reference's FID is
torchmetrics ``FrechetInceptionDistance(feature=64)``, whose extractor is
pytorch-fid's InceptionV3 tapped after the first max-pool (64 channels; the
192 tap is one conv block later). Up to those taps the network is the
torchvision stem, BasicConv2d = bias-free conv + BatchNorm (eps 1e-3) + ReLU,
so the head is five convs, built here from a local state dict (torchvision
``inception_v3`` or pytorch-fid layout, the same keys) with no torchvision
and no download. A missing key raises ``KeyError``: a partly loaded head
would give a meaningless FID.

Input contract (pytorch-fid ``resize_input`` + ``normalize_input``): NHWC
images in [0, 1], resized to 299x299 bilinearly with half-pixel centres
(``align_corners=False``), grey images repeated to three channels after the
resize, then scaled to [-1, 1]; the features are the spatial mean.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["FEATURE_TAPS", "InceptionHead", "load_inception_head", "head_feature_fn"]

# (name, stride, padding) in order; the 64 tap follows the max-pool after
# Conv2d_2b_3x3, the 192 tap the one after Conv2d_4a_3x3
_STEM = (("Conv2d_1a_3x3", 2, 0), ("Conv2d_2a_3x3", 1, 0), ("Conv2d_2b_3x3", 1, 1))
_BLOCK1 = (("Conv2d_3b_1x1", 1, 0), ("Conv2d_4a_3x3", 1, 0))
FEATURE_TAPS = (64, 192)
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


class InceptionHead(nn.Module):
    """The stem up to the ``feature`` tap, in eval mode, weights as buffers."""

    def __init__(self, state_dict, feature: int = 64):
        super().__init__()
        if feature not in FEATURE_TAPS:
            raise ValueError(f"feature={feature}: this head taps {FEATURE_TAPS}")
        self.feature = feature
        self.blocks = _STEM + (_BLOCK1 if feature == 192 else ())
        for name, _, _ in self.blocks:
            self.register_buffer(f"{name}_w", state_dict[f"{name}.conv.weight"].float().clone())
            for k in _BN_KEYS:
                self.register_buffer(f"{name}_{k}", state_dict[f"{name}.bn.{k}"].float().clone())

    def _block(self, x, name, stride, padding):
        x = F.conv2d(x, getattr(self, f"{name}_w"), stride=stride, padding=padding)
        w, b, mean, var = (getattr(self, f"{name}_{k}") for k in _BN_KEYS)
        return F.relu(F.batch_norm(x, mean, var, w, b, training=False, eps=1e-3))

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C (1 | 3)] images in [0, 1] -> [B, feature]."""
        x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(299, 299),
                          mode="bilinear", align_corners=False)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = x * 2.0 - 1.0
        for i, (name, stride, padding) in enumerate(self.blocks):
            x = self._block(x, name, stride, padding)
            if i in (len(_STEM) - 1, len(self.blocks) - 1):
                x = F.max_pool2d(x, kernel_size=3, stride=2)
        return x.mean(dim=(2, 3))


def load_inception_head(weights_path: str, feature: int = 64, device="cpu") -> InceptionHead:
    """The head from a local torch file: a state dict or a whole pickled module."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return InceptionHead(sd, feature).to(device).eval()


def head_feature_fn(head: InceptionHead, batch_size: int = 64,
                    device="cpu") -> Callable[[np.ndarray], np.ndarray]:
    """numpy [B, H, W, C] in [0, 1] -> numpy [B, feature] float32, for ``quality.FID``."""
    def fn(images: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(np.asarray(images[i:i + batch_size], np.float32)).to(device)
            out.append(head(x).cpu().numpy())
        return np.concatenate(out, axis=0)

    return fn
