"""Data parallelism across processes: start-up, rank shards and collectives.

The port's counterpart of ``causaldiffae_tpu/parallel/mesh.py:137-151`` and
``collectives.py:22-57``. One process per card (``torchrun``), the model
wrapped in DDP by the train loop; ``--batch_size`` is the GLOBAL batch, and
each rank feeds its ``batch_size / W`` rows. Every function here is the
identity, or answers for one process, when ``torch.distributed`` is not
initialised.
"""

from .collectives import (barrier, gather_across_ranks, is_primary, mean_across_ranks, rank,
                          reduce_metrics, sum_across_ranks, world_size)
from .dist import init_from_env, local_batch_size, rank_rows

__all__ = ["barrier", "gather_across_ranks", "is_primary", "mean_across_ranks", "rank",
           "reduce_metrics", "sum_across_ranks", "world_size", "init_from_env",
           "local_batch_size", "rank_rows"]
