"""Data and tensor parallelism across processes: start-up, the process grid,
rank shards and collectives.

The port's counterpart of ``causaldiffae_tpu/parallel/mesh.py:30-38,137-151``
and ``collectives.py:22-57``. One process per card (``torchrun``);
``--batch_size`` is the GLOBAL batch. With ``model_parallel = k`` the ranks
form a grid of W/k data rows by k model ranks (``grid.py``); the k ranks of
a row hold the same rows and one shard each of the Megatron-sharded
ResBlocks (``partition.py``, imported from there: it needs the models). The
train loop wraps the model in DDP over the DP group when it has more than
one rank, and each data row feeds its ``batch_size / (W/k)`` rows. Every
function here is the identity, or answers for one process, when
``torch.distributed`` is not initialised.
"""

from .collectives import (barrier, gather_across_ranks, is_primary, mean_across_ranks, rank,
                          reduce_metrics, sum_across_ranks, world_size)
from .dist import init_from_env, local_batch_size, rank_rows
from .grid import dp_group, dp_rank, dp_size, init_grid, tp_group, tp_rank, tp_size

__all__ = ["barrier", "gather_across_ranks", "is_primary", "mean_across_ranks", "rank",
           "reduce_metrics", "sum_across_ranks", "world_size", "init_from_env",
           "local_batch_size", "rank_rows", "dp_group", "dp_rank", "dp_size", "init_grid",
           "tp_group", "tp_rank", "tp_size"]
