"""Anti-causal probes: the instruments of effectiveness MAE.

Port of ``causaldiffae_tpu/evals/classifiers.py:97-278``: MSE regression of
one causal factor from images with the ``GaussianConvEncoderClf`` trunk,
Adam(1e-3) with optax's defaults (b1 0.9, b2 0.999, eps 1e-8; torch's Adam
has the same update), drop-last batches over a per-epoch shuffle, and the
weights of the epoch with the best validation MSE kept (strict ``<``). The
JAX package's fused whole-fit scan and its streaming loop are one torch loop
here: the pools stay on the device when they fit, else each batch is copied.

The shuffle comes from a ``torch.Generator`` seeded by (seed, epoch), which
cannot reproduce ``jax.random.permutation``: probes trained by the two
packages from the same seed differ, and MAE compares across packages only
when both score with the same probe files (:func:`load_classifier` reads the
JAX package's pickles).

Factor columns: morphomnist 0 thickness, 1 intensity; pendulum 0 angle,
1 light, 2 shadow_len, 3 shadow_pos; circuit 0 arm, 1 blue, 2 green, 3 red.
"""

from __future__ import annotations

import math
import pickle
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.encoder import GaussianConvEncoderClf
from ..utils import logger
from ..utils.weights import classifier_state_dict_from_flax

__all__ = ["ClassifierTrainer", "load_classifier", "classifier_predict_fn"]

POOL_BYTE_LIMIT = 2 << 30  # larger image pools stay on the host, one batch copied at a time


def _pool(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device) if a.nbytes <= POOL_BYTE_LIMIT else t


def _epoch_seed(seed: int, epoch: int) -> int:
    return (seed * 1_000_003 + epoch) % (1 << 63)


class ClassifierTrainer:
    """Train one probe for column ``factor`` of the labels ``c``."""

    def __init__(self, dataset: str, factor: int, n_vars: int, lr: float = 1e-3,
                 seed: int = 0, hidden_dims: Optional[Tuple[int, ...]] = None,
                 device="cuda"):
        self.dataset, self.factor, self.n_vars = dataset, factor, n_vars
        self.lr, self.seed, self.hidden_dims, self.device = lr, seed, hidden_dims, device
        self.best_val = math.inf
        self.best_state: Optional[Dict[str, torch.Tensor]] = None

    def init(self, sample_images: np.ndarray) -> None:
        """A seeded probe for NHWC images shaped like ``sample_images``, and its optimizer."""
        _, size, _, channels = sample_images.shape
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            model = GaussianConvEncoderClf(channels, size, self.n_vars, self.hidden_dims)
        self.model = model.to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def train_step(self, images: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """One Adam step on the MSE of column ``factor``; BatchNorm on the
        batch's statistics, its running buffers updated. Returns the loss."""
        self.model.train()
        target = c[:, self.factor:self.factor + 1]
        loss = torch.mean((self.model(images) - target) ** 2)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def validate(self, val_data: Dict[str, np.ndarray], batch_size: int = 128) -> float:
        """MSE of column ``factor`` over the whole pool, BatchNorm on its running statistics."""
        self.model.eval()
        images, c = val_data["image"], val_data["c"][:, self.factor:self.factor + 1]
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(images[i:i + batch_size]).to(self.device)
            y = torch.from_numpy(c[i:i + batch_size]).to(self.device)
            total += ((self.model(x) - y) ** 2).sum(dtype=torch.float64)
        return float(total) / len(images)

    def fit(self, train_data: Dict[str, np.ndarray], val_data: Dict[str, np.ndarray],
            epochs: int = 100, batch_size: int = 128, log_every: int = 10):
        """Train for ``epochs`` and keep the best-validation weights; returns them."""
        t0 = time.perf_counter()
        n = len(train_data["image"])
        # drop-last batches, the coverage of range(0, n - batch_size + 1, batch_size)
        nb = max(1, (n - batch_size) // batch_size + 1)
        batch_size = min(batch_size, n)
        self.init(train_data["image"][:2])
        x, c = _pool(train_data["image"], self.device), _pool(train_data["c"], self.device)
        for epoch in range(epochs):
            gen = torch.Generator().manual_seed(_epoch_seed(self.seed, epoch))
            sels = torch.randperm(n, generator=gen)[:nb * batch_size].view(nb, batch_size)
            losses = [self.train_step(x[sel.to(x.device)].to(self.device),
                                      c[sel.to(c.device)].to(self.device)) for sel in sels]
            val = self.validate(val_data, batch_size)
            if val < self.best_val:
                self.best_val = val
                self.best_state = {k: v.detach().clone()
                                   for k, v in self.model.state_dict().items()}
            if epoch % log_every == 0:
                logger.log(f"clf[{self.dataset}:{self.factor}] epoch {epoch} "
                           f"train {float(torch.stack(losses).mean()):.5f} val {val:.5f} "
                           f"best {self.best_val:.5f}")
        seconds = time.perf_counter() - t0
        samples = epochs * nb * batch_size
        logger.log(f"clf[{self.dataset}:{self.factor}] {epochs} epochs of {nb} batches of "
                   f"{batch_size} in {seconds:.2f} s ({samples / seconds:.0f} samples/s), "
                   f"best val {self.best_val:.5f}")
        return self.best_state

    def save_best(self, path: str) -> None:
        """Pickle the best weights (numpy, the probe's keys) with their meta."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({
                "state_dict": {k: v.cpu().numpy() for k, v in self.best_state.items()},
                "dataset": self.dataset,
                "factor": self.factor,
                "best_val": self.best_val,
            }, f)


def load_classifier(path: str, n_vars: int, image_size: int, in_channels: int,
                    hidden_dims: Optional[Tuple[int, ...]] = None, device="cpu"):
    """A saved probe, in eval mode on ``device``, and its meta -> (model, meta).

    Reads three kinds of file: the port's pickles (:meth:`ClassifierTrainer.save_best`),
    the JAX package's pickles (flax variables as numpy trees, carried
    across by ``classifier_state_dict_from_flax``) and the reference's
    ``classifier_<factor>_best.pth``, whose dead ``fc_mu``/``fc_var`` heads
    are dropped by name. Every other key loads strictly.
    """
    model = GaussianConvEncoderClf(in_channels, image_size, n_vars, hidden_dims)
    if str(path).endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if not k.startswith(("fc_mu.", "fc_var."))}
        meta = {"source": "torch", "path": str(path), "best_val": float("nan")}
    else:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if "variables" in blob:
            sd = classifier_state_dict_from_flax(blob["variables"])
        else:
            sd = {k: torch.from_numpy(np.asarray(v)) for k, v in blob["state_dict"].items()}
        meta = {k: v for k, v in blob.items() if k not in ("variables", "state_dict")}
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval(), meta


def classifier_predict_fn(model: GaussianConvEncoderClf):
    """``predict(images NHWC) -> [B]``: the probe's scalar output, eval mode."""
    model.eval()

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        return model(images)[:, 0]

    return predict
