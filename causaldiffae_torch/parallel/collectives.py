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

Under tensor parallelism (``parallel/grid.py``) the ranks of a TP group
hold the same rows, so the train step's batch reductions pass the DP group
(``grid.dp_group()``); ``group=None`` is WORLD, which the evaluation CLIs
keep. The TP ResBlock's two operators are here too, Megatron's f
(:func:`copy_to_group`) and g (:func:`reduce_from_group`), with
``TP_ALL_REDUCES``, the count of their all-reduces by where they ran.

Every function is the identity, or answers for one process, when
``torch.distributed`` is not initialised.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["rank", "world_size", "is_primary", "barrier", "gather_across_ranks",
           "mean_across_ranks", "sum_across_ranks", "reduce_metrics", "copy_to_group",
           "reduce_from_group", "all_reduce_", "TP_ALL_REDUCES"]

# the TP operators' all-reduces since the last reset: "forward" (g in the
# forward pass), "recompute" (g again when remat reruns a block inside the
# backward pass), "backward" (f's gradient), "step" (the norms of sharded
# tensors, all_reduce_)
TP_ALL_REDUCES = {"forward": 0, "recompute": 0, "backward": 0, "step": 0}


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """The ranks in ``group`` (WORLD when None); 1 without a process group."""
    return dist.get_world_size(group) if _active() else 1


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


def gather_across_ranks(x: np.ndarray, group: Optional[dist.ProcessGroup] = None) -> np.ndarray:
    """Every rank's ``x`` (of one shape on all ranks of ``group``, WORLD when
    None) concatenated on axis 0, in rank order, on every rank."""
    x = np.ascontiguousarray(x)
    if world_size(group) == 1:
        return x
    t = torch.from_numpy(x).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t, group=group)
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
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _SumAcrossRanks.apply(g, ctx.group), None


def sum_across_ranks(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``x``, a sum over this rank's rows, summed over the rows of every rank
    of ``group`` (WORLD when None), its gradient summed back to every rank
    (``x`` itself in one process or a group of one)."""
    if world_size(group) == 1:
        return x
    return _SumAcrossRanks.apply(x, group)


def _in_backward() -> bool:
    """Whether the autograd engine is running a backward pass on this thread
    (as ``torch.utils.checkpoint`` asks it): a forward op then is remat's
    recompute."""
    return torch._C._current_graph_task_id() != -1


def all_reduce_(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                where: str = "step") -> torch.Tensor:
    """Sum ``x`` over ``group`` in place, counted in ``TP_ALL_REDUCES[where]``."""
    TP_ALL_REDUCES[where] += 1
    dist.all_reduce(x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the gradient
    over the TP group, so that a replicated tensor feeding a sharded op gets
    the gradient of every shard."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group,
                           "backward"), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the forward sums the shards' partial outputs over the TP
    group, in their dtype; the backward is the identity (every rank holds the
    same gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        return all_reduce_(out, group, "recompute" if _in_backward() else "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """f over the TP ``group``: ``x`` forward, the gradient summed backward."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """g over the TP ``group``: ``x`` summed forward, the gradient as it is backward."""
    return _ReduceFromGroup.apply(x, group)


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """The train step's per-rank scalar metrics as one process at the global
    batch reports them, in one all-reduce over ``group`` (WORLD when None;
    the train loop passes the DP group, whose ranks hold different rows): a
    value with a ``<key>_count`` (a quartile bucket's mean) is weighted by
    its count, a count is summed, anything else averaged over the ranks (the
    ranks' shares are equal)."""
    if world_size(group) == 1:
        return metrics
    keys = sorted(metrics)
    counted = {k for k in keys if f"{k}_count" in metrics}
    vals = torch.stack([(metrics[k] * metrics[f"{k}_count"] if k in counted else metrics[k])
                        .detach().float().reshape(()) for k in keys])
    dist.all_reduce(vals, group=group)
    at = dict(zip(keys, vals))
    out = {}
    for k in keys:
        if k in counted:
            out[k] = at[k] / at[f"{k}_count"].clamp(min=1.0)
        elif k.endswith("_count"):
            out[k] = at[k]
        else:
            out[k] = at[k] / world_size(group)
    return out
