"""Collectives of the data-parallel train step, the train loop and the
evaluation CLIs.

The port's counterpart of ``causaldiffae_tpu/parallel/collectives.py:22-57``.
The JAX step is one program over the global batch, so each of its batch
reductions (the encoder's BatchNorm statistics, the masked KL, the flow's
``-mean(log_det)``) is global. Under DDP each rank holds its share of the
batch, and the step takes those reductions through
:func:`sum_across_ranks`, an all-reduce whose gradient is summed back
across the ranks as well, so that DDP's mean of the ranks' gradients is the
gradient of the global objective.

Every function is the identity, or answers for one process, when
``torch.distributed`` is not initialised.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["rank", "world_size", "is_primary", "barrier", "gather_across_ranks",
           "mean_across_ranks", "sum_across_ranks", "reduce_metrics"]


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (e.g. until the primary has written a file the
    others read)."""
    if _active():
        dist.barrier()


def _comm_device() -> torch.device:
    """Where a host array goes for a collective: the rank's card under NCCL,
    else the CPU (gloo gathers CPU tensors)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_across_ranks(x: np.ndarray) -> np.ndarray:
    """Every rank's ``x`` (of one shape on all ranks) concatenated on axis 0,
    in rank order, on every rank."""
    x = np.ascontiguousarray(x)
    if world_size() == 1:
        return x
    t = torch.from_numpy(x).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def mean_across_ranks(value: float) -> float:
    """The mean of the ranks' values (``mean_across_hosts``: the mean of per-rank means)."""
    if world_size() == 1:
        return float(value)
    return float(np.mean(gather_across_ranks(np.asarray([value], dtype=np.float64))))


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient, as
    ``torch.distributed.nn.functional.all_reduce`` does: each rank's share
    of a global sum gets the gradient that every rank's loss sends it."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _SumAcrossRanks.apply(g)


def sum_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's rows, summed over every rank's rows, its
    gradient summed back to every rank (``x`` itself in one process)."""
    if not _active():
        return x
    return _SumAcrossRanks.apply(x)


def reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The train step's per-rank scalar metrics as one process at the global
    batch reports them, in one all-reduce: a value with a ``<key>_count``
    (a quartile bucket's mean) is weighted by its count, a count is summed,
    anything else averaged over the ranks (the ranks' shares are equal)."""
    if not _active():
        return metrics
    keys = sorted(metrics)
    counted = {k for k in keys if f"{k}_count" in metrics}
    vals = torch.stack([(metrics[k] * metrics[f"{k}_count"] if k in counted else metrics[k])
                        .detach().float().reshape(()) for k in keys])
    dist.all_reduce(vals)
    at = dict(zip(keys, vals))
    out = {}
    for k in keys:
        if k in counted:
            out[k] = at[k] / at[f"{k}_count"].clamp(min=1.0)
        elif k.endswith("_count"):
            out[k] = at[k]
        else:
            out[k] = at[k] / world_size()
    return out
