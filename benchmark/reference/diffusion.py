"""Plain reference of the diffusion process the two cells run.

The linear beta schedule and its coefficients in float64, stored float32
(Ho et al.; the reference repository's ``gaussian_diffusion.py``), the
respacing of ``respace.py``, ``q_sample``, the x0 prediction with clipping,
and the DPM-Solver++(2M) node grid and step of Lu et al. 2022
(arXiv:2211.01095) on a lambda-uniform grid.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def linear_betas(steps: int) -> np.ndarray:
    scale = 1000 / steps
    return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)


def respaced(betas: np.ndarray, count: int):
    """(betas of the ``count`` kept steps, their original timesteps): the
    kept steps evenly strided over the process, each new beta chosen so the
    kept steps' cumulative products stay as they were."""
    n = len(betas)
    stride = 1 if count <= 1 else (n - 1) / (count - 1)
    keep = {round(i * stride) for i in range(count)}
    acp = np.cumprod(1.0 - betas)
    last, new, where = 1.0, [], []
    for i, a in enumerate(acp):
        if i in keep:
            new.append(1 - a / last)
            last = a
            where.append(i)
    return np.asarray(new), np.asarray(where, dtype=np.int64)


class Process:
    """One diffusion process: coefficients as float32 tensors on ``device``,
    and ``model_t``, the timesteps the model is given."""

    def __init__(self, steps: int, device, respacing: Optional[int] = None):
        betas = linear_betas(steps)
        self.model_map = np.arange(steps, dtype=np.int64)
        if respacing:
            betas, self.model_map = respaced(betas, respacing)
        acp = np.cumprod(1.0 - betas)
        # the solver's grid is worked out from the schedule as stored, float32
        self.alphas_cumprod = acp.astype(np.float32).astype(np.float64)
        f = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)  # noqa: E731
        self.sqrt_acp = f(np.sqrt(acp))
        self.sqrt_1macp = f(np.sqrt(1.0 - acp))
        self.sqrt_recip = f(np.sqrt(1.0 / acp))
        self.sqrt_recipm1 = f(np.sqrt(1.0 / acp - 1.0))
        self.map = torch.tensor(self.model_map, device=device)
        self.num_timesteps = len(betas)

    @staticmethod
    def _at(arr: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return arr[t].reshape(-1, 1, 1, 1)

    def q_sample(self, x0, t, noise):
        return self._at(self.sqrt_acp, t) * x0 + self._at(self.sqrt_1macp, t) * noise

    def model_t(self, t):
        return self.map[t]

    def pred_x0(self, x, t, eps):
        x0 = self._at(self.sqrt_recip, t) * x - self._at(self.sqrt_recipm1, t) * eps
        return x0.clamp(-1.0, 1.0)

    def dpm_nodes(self, num_steps: int) -> Dict[str, np.ndarray]:
        """The descending node timesteps and, per step, sigma_i / sigma_{i-1}
        ("sratio"), alpha_i ("a_next"), e^{-h_i} - 1 ("phi") and the 2M
        extrapolation weight ("c2"), in float64, rounded to float32."""
        N = self.num_timesteps
        acp = self.alphas_cumprod
        lam_all = 0.5 * np.log(acp / (1.0 - acp))
        targets = np.linspace(lam_all[N - 1], lam_all[0], num_steps)
        nodes = {int(np.argmin(np.abs(lam_all - tg))) for tg in targets} | {N - 1, 0}
        desc = np.asarray(sorted(nodes, reverse=True))
        alpha, sigma = np.sqrt(acp[desc]), np.sqrt(1.0 - acp[desc])
        lam = np.log(alpha / sigma)
        h = np.append(lam[1:] - lam[:-1], np.inf)
        c2 = np.zeros(len(desc))
        if len(desc) >= 3:
            c2[1:-1] = h[1:-1] / (2.0 * h[:-2])
        f = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
        return {"t": desc, "sratio": f(np.append(sigma[1:], 0.0) / sigma),
                "a_next": f(np.append(alpha[1:], 1.0)), "phi": f(np.expm1(-h)), "c2": f(c2)}


def kl_normal(qm, qv, pm, pv) -> torch.Tensor:
    """KL(N(qm, qv) || N(pm, pv)) of diagonal Gaussians given by variances,
    summed over the last axis."""
    return (0.5 * (torch.log(pv) - torch.log(qv) + qv / pv + (qm - pm) ** 2 / pv - 1.0)).sum(-1)


def kl_weight(step: int, anneal_steps: int) -> float:
    """The representation KL's weight at ``step``: step / (anneal - 1), in
    float32, clipped to [0, 1]."""
    w = np.float32(step) / np.float32(anneal_steps - 1)
    return float(np.clip(w, np.float32(0.0), np.float32(1.0)))
