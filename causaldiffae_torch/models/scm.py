"""SCM latent layer: adjacency-masked causal mixing.

Port of ``causaldiffae_tpu/models/scm.py:35-102`` (``CausalModeling`` with
its per-variable MLPs). The latent u is reshaped to (n_vars, d) blocks,
``z_pre = A^T u`` mixes parent blocks into each variable, and
``z_post_i = g_i(z_pre_i) + u_i``. The per-variable MLPs keep the
reference's ModuleList layout (``nonlinearities.{i}.net.{0,2}``) and are
evaluated as one batched product over stacked weights. Everything runs in
fp32. The flow prior (``MultivariateCausalFlow``) is not used by the
flagship preset and is not ported yet.
"""

from __future__ import annotations

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
