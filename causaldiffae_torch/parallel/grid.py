"""The (data x model) process grid of tensor parallelism.

The port's counterpart of ``causaldiffae_tpu/parallel/mesh.py:30-38``
(``make_mesh`` with a model axis). With ``model_parallel = k``, W ranks form
a grid of W/k data rows by k model columns, the model rank innermost as the
mesh folds it: global rank = dp_rank * k + tp_rank. The k ranks of a data
row are one TP group: they hold the same rows of the batch and one shard
each of the sharded ResBlocks (``parallel/partition.py``). The W/k ranks of a
model column are one DP group: they hold the same shard and different rows,
and every batch reduction of the train step runs over it.

:func:`init_grid` builds the groups; every rank calls ``new_group`` for
every group in the same order, as ``torch.distributed`` requires. At k = 1
nothing is built: the DP group is WORLD (``None``) and the TP group is
unused. Until :func:`init_grid` is called the queries answer for k = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from .collectives import rank, world_size

__all__ = ["Grid", "init_grid", "tp_size", "tp_rank", "tp_group", "dp_size", "dp_rank",
           "dp_group"]


@dataclasses.dataclass(frozen=True)
class Grid:
    tp: int                  # ranks per data row (model_parallel)
    dp: int                  # data rows
    tp_rank: int             # this rank's column
    dp_rank: int             # this rank's row
    world: int
    tp_group: Optional[dist.ProcessGroup] = None   # this rank's row; None at tp = 1
    dp_group: Optional[dist.ProcessGroup] = None   # this rank's column; None: WORLD


_GRID: Optional[Grid] = None


def init_grid(model_parallel: int) -> Grid:
    """The grid of ``model_parallel`` model ranks per data row over this
    process group, built once (a second call with the same size returns it).

    Raises unless ``model_parallel`` divides the world size, as ``make_mesh``
    asserts; one process with no process group has world size 1, so any
    ``model_parallel > 1`` is refused there."""
    global _GRID
    tp, world = int(model_parallel), world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"model_parallel {tp} does not divide the world size {world}: "
                         f"the grid needs world = data rows x model ranks")
    if _GRID is not None and (_GRID.tp, _GRID.world) == (tp, world):
        return _GRID
    r = rank()
    if tp == 1:
        _GRID = Grid(1, world, 0, r, world)
        return _GRID
    dp = world // tp
    rows = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(dp)]
    columns = [dist.new_group(list(range(m, world, tp))) for m in range(tp)]
    _GRID = Grid(tp, dp, r % tp, r // tp, world, rows[r // tp], columns[r % tp])
    return _GRID


def _grid() -> Grid:
    if _GRID is not None:
        return _GRID
    return Grid(1, world_size(), 0, rank(), world_size())


def tp_size() -> int:
    return _grid().tp


def tp_rank() -> int:
    return _grid().tp_rank


def tp_group() -> Optional[dist.ProcessGroup]:
    return _grid().tp_group


def dp_size() -> int:
    return _grid().dp


def dp_rank() -> int:
    return _grid().dp_rank


def dp_group() -> Optional[dist.ProcessGroup]:
    """The group every batch reduction of the train step runs over; ``None``
    (WORLD) at tp = 1."""
    return _grid().dp_group
