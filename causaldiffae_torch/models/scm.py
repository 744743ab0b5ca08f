"""SCM latent layers: adjacency-masked causal mixing and the flow prior.

Port of ``causaldiffae_tpu/models/scm.py:35-181``. ``CausalModeling`` (with
its per-variable MLPs): the latent u is reshaped to (n_vars, d) blocks,
``z_pre = A^T u`` mixes parent blocks into each variable, and
``z_post_i = g_i(z_pre_i) + u_i``. The per-variable MLPs keep the
reference's ModuleList layout (``nonlinearities.{i}.net.{0,2}``) and are
evaluated as one batched product over stacked weights.
``MultivariateCausalFlow`` (``flow_based=True``): a masked affine
autoregressive flow over the same blocks, its two conditioners under the
reference keys ``causal_flow.{s,t}_cond.{0,2,4}``. Everything runs in fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class MLP(nn.Module):
    """Linear(d -> hidden), LeakyReLU, Linear(hidden -> d) (reference `nn.py:225-240`)."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(d, hidden), nn.LeakyReLU(0.01), nn.Linear(hidden, d))


class CausalModeling(nn.Module):
    """Adjacency-masked SCM over latent blocks."""

    def __init__(self, latent_dim: int, num_var: int,
                 adjacency: Optional[Tuple[Tuple[float, ...], ...]] = None,
                 learn_adjacency: bool = False):
        super().__init__()
        self.latent_dim = latent_dim
        self.num_var = num_var
        if learn_adjacency:
            self.A = nn.Parameter(torch.zeros(num_var, num_var))
        else:
            if adjacency is None:
                raise ValueError("need a static adjacency or learn_adjacency")
            self.register_buffer("A", torch.tensor(adjacency, dtype=torch.float32),
                                 persistent=False)
        self.nonlinearities = nn.ModuleList(
            MLP(latent_dim // num_var, latent_dim) for _ in range(num_var))

    def causal_masking(self, u: torch.Tensor) -> torch.Tensor:
        """z_pre = A^T @ u over variable blocks (reference `nn.py:290-295`)."""
        ub = u.reshape(-1, self.num_var, self.latent_dim // self.num_var)
        return torch.einsum("ji,bjd->bid", self.A, ub)

    def nonlinearity_add_back_noise(self, u: torch.Tensor, z_pre: torch.Tensor) -> torch.Tensor:
        """z_post_i = g_i(z_pre_i) + u_i, flattened back (reference `nn.py:297-312`)."""
        n = self.num_var
        ub = u.reshape(-1, n, self.latent_dim // n)
        w1 = torch.stack([m.net[0].weight for m in self.nonlinearities])  # [n, hid, d]
        b1 = torch.stack([m.net[0].bias for m in self.nonlinearities])
        w2 = torch.stack([m.net[2].weight for m in self.nonlinearities])  # [n, d, hid]
        b2 = torch.stack([m.net[2].bias for m in self.nonlinearities])
        h = F.leaky_relu(torch.einsum("bnd,nhd->bnh", z_pre, w1) + b1[None], 0.01)
        z_post = torch.einsum("bnh,ndh->bnd", h, w2) + b2[None] + ub
        return z_post.reshape(-1, self.latent_dim)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return self.nonlinearity_add_back_noise(u, self.causal_masking(u))


class _SigmoidMLP(nn.Sequential):
    """Linear(nh)-ReLU-Linear(nh)-ReLU-Linear(k)-Sigmoid (reference `nn.py:350-366`)."""

    def __init__(self, d_in: int, k: int, nh: int = 100):
        super().__init__(nn.Linear(d_in, nh), nn.ReLU(), nn.Linear(nh, nh), nn.ReLU(),
                         nn.Linear(nh, k), nn.Sigmoid())


class MultivariateCausalFlow(nn.Module):
    """Masked affine autoregressive flow over (dim, k) latent blocks.

    ``causaldiffae_tpu/models/scm.py:122-181`` (reference `nn.py:342-426`).
    The conditioners of variable i read the latent through the mask column
    i of C = I - A, repeated over each k-block. The reference's quirks stay:
    ``flow`` and ``reverse`` are not exact inverses (C's self block is zero
    while ``flow`` builds z and populated when ``reverse`` reads it), and the
    reverse prior is N(1, I).
    """

    def __init__(self, dim: int, k: int, nh: int = 100):
        super().__init__()
        self.dim, self.k = dim, k
        self.s_cond = _SigmoidMLP(dim * k, k, nh)
        self.t_cond = _SigmoidMLP(dim * k, k, nh)

    def _mask(self, C: torch.Tensor, i: int) -> torch.Tensor:
        """Flattened per-dim mask: column C[:, i] repeated over each k-block."""
        return C[:, i].repeat_interleave(self.k)

    def flow(self, e: torch.Tensor, C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """e -> (z, log|dz/de|) (reference `nn.py:368-393`)."""
        B = e.shape[0]
        eb = e.reshape(B, self.dim, self.k)
        zs = []
        log_det = torch.zeros((B,), dtype=e.dtype, device=e.device)
        for i in range(self.dim):
            # z with blocks < i computed and the rest still zero
            z = torch.cat(zs + [eb.new_zeros(B, self.dim - i, self.k)], dim=1)
            zin = z.reshape(B, -1) * self._mask(C, i)[None]
            s = self.s_cond(zin)
            zs.append((torch.exp(s) * eb[:, i] + self.t_cond(zin))[:, None])
            log_det = log_det + s.sum(dim=1)
        return torch.cat(zs, dim=1).reshape(B, -1), log_det

    def reverse(self, z: torch.Tensor, C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z -> (log_det, log-probability of e under N(1, I)) (reference `nn.py:395-426`)."""
        B = z.shape[0]
        zb = z.reshape(B, self.dim, self.k)
        es = []
        log_det = torch.zeros((B,), dtype=z.dtype, device=z.device)
        for i in range(self.dim):
            zin = zb.reshape(B, -1) * self._mask(C, i)[None]
            s = self.s_cond(zin)
            es.append(torch.exp(-s) * (zb[:, i] - self.t_cond(zin)))
            log_det = log_det - s.sum(dim=1)
        ef = torch.stack(es, dim=1).reshape(B, -1)
        total = self.dim * self.k
        p_log_prob = -0.5 * (((ef - 1.0) ** 2).sum(dim=1) + total * math.log(2 * math.pi))
        return log_det, p_log_prob
