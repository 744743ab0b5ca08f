"""Timestep schedule samplers.

Port of ``causaldiffae_tpu/training/samplers.py:26-92``: ``uniform`` and
``loss-second-moment`` (importance sampling by the RMS of each timestep's
last 10 losses, once every timestep has 10). The loss-aware sampler's state
is a small ``[num_timesteps, 10]`` history kept on the host as numpy, and
its update pushes the batch's (t, loss) pairs one by one, so duplicate
timesteps in one batch behave as in the JAX package's sequential scan;
under data parallelism it gathers every rank's pairs first.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import gather_across_ranks
from ..parallel.grid import dp_group, dp_size

__all__ = ["init_sampler_state", "sampler_weights", "sample_timesteps",
           "timestep_weights", "update_sampler_state"]

SamplerState = Optional[Dict[str, np.ndarray]]
HISTORY_PER_TERM = 10


def init_sampler_state(name: str, num_timesteps: int) -> SamplerState:
    """None for uniform; {history, counts} for loss-second-moment, with
    ``HISTORY_PER_TERM`` losses kept per timestep."""
    if name == "uniform":
        return None
    if name == "loss-second-moment":
        return {"history": np.zeros((num_timesteps, HISTORY_PER_TERM), np.float32),
                "counts": np.zeros((num_timesteps,), np.int32)}
    raise NotImplementedError(f"unknown schedule sampler: {name}")


def sampler_weights(state: SamplerState, num_timesteps: int,
                    uniform_prob: float = 0.001) -> np.ndarray:
    """Unnormalised sampling weights, fp32 [num_timesteps]: uniform until
    every timestep's history is full, then sqrt(mean(loss^2)) mixed with a
    ``uniform_prob`` floor."""
    ones = np.ones((num_timesteps,), np.float32)
    if state is None or not np.all(state["counts"] == state["history"].shape[1]):
        return ones
    w = np.sqrt(np.mean(state["history"] ** 2, axis=-1, dtype=np.float32))
    w = w / np.float32(max(float(w.sum()), 1e-12))
    return (w * np.float32(1 - uniform_prob) + np.float32(uniform_prob / num_timesteps)
            ).astype(np.float32)


def timestep_weights(state: SamplerState, num_timesteps: int, t: torch.Tensor) -> torch.Tensor:
    """The importance weights 1 / (num_timesteps * p[t]) of drawn timesteps."""
    if state is None:
        return torch.ones(t.shape, dtype=torch.float32, device=t.device)
    w = sampler_weights(state, num_timesteps)
    p = torch.from_numpy(w / w.sum()).to(t.device)
    return 1.0 / (num_timesteps * p[t])


def sample_timesteps(state: SamplerState, num_timesteps: int, batch_size: int,
                     generator: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample (t, loss weights); uniform draws stay on ``device``."""
    if state is None:
        t = torch.randint(0, num_timesteps, (batch_size,), generator=generator, device=device)
    else:
        w = sampler_weights(state, num_timesteps)
        p = torch.from_numpy(w / w.sum()).to(device)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
    return t, timestep_weights(state, num_timesteps, t)


def update_sampler_state(state: SamplerState, t: torch.Tensor, losses: torch.Tensor,
                         rows: Optional[np.ndarray] = None) -> SamplerState:
    """Push each (t, loss) pair, in batch order, into its timestep's ring
    history: append until the row holds ``HISTORY_PER_TERM`` losses, then
    shift out the oldest. Reads t and the losses back to the host.

    Under data parallelism each rank passes its own rows' pairs and their
    places in the global batch (``rows``): every rank gathers the pairs of
    its DP group (whose ranks hold different rows) and pushes them in global
    batch order, so that every rank's
    history is the one a single process at the global batch keeps
    (``causaldiffae_tpu/training/samplers.py:5-9``)."""
    if state is None:
        return None
    t_np = t.cpu().numpy()
    l_np = losses.detach().float().cpu().numpy()
    if rows is not None and dp_size() > 1:
        group = dp_group()
        order = np.argsort(gather_across_ranks(np.asarray(rows, np.int64), group), kind="stable")
        t_np = gather_across_ranks(t_np, group)[order]
        l_np = gather_across_ranks(l_np, group)[order]
    history, counts = state["history"].copy(), state["counts"].copy()
    size = history.shape[1]
    for ti, li in zip(t_np.tolist(), l_np.tolist()):
        if counts[ti] == size:
            history[ti, :-1] = history[ti, 1:]
            history[ti, -1] = li
        else:
            history[ti, counts[ti]] = li
            counts[ti] += 1
    return {"history": history, "counts": counts}
