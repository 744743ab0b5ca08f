"""Process-group start-up from ``torchrun``'s environment, and each rank's rows.

The port's counterpart of ``causaldiffae_tpu/parallel/mesh.py:137-151``
(``host_local_batch_size``). ``torchrun --nproc_per_node N`` starts one
process per card and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous address; :func:`init_from_env` joins that group (NCCL on the
card, gloo on the CPU) and pins each rank to ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_from_env", "local_batch_size", "rank_rows"]


def init_from_env(device: str) -> str:
    """Join the process group ``torchrun`` describes; returns this rank's device.

    Outside ``torchrun`` (no ``WORLD_SIZE`` in the environment), or with a
    group already initialised by the caller, nothing is started and
    ``device`` comes back as given. Under ``torchrun`` a ``cuda`` device
    becomes ``cuda:LOCAL_RANK`` (one card per local rank) with an NCCL group;
    any other device gets a gloo group."""
    if (dist.is_available() and dist.is_initialized()) or "WORLD_SIZE" not in os.environ:
        return device
    if device.startswith("cuda"):
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl")
        return f"cuda:{local}"
    dist.init_process_group("gloo")
    return device


def local_batch_size(global_batch: int, world: int) -> int:
    """Each rank's share of the global batch; raises unless ``world`` divides it."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} is not divisible by {world} ranks")
    return global_batch // world


def rank_rows(batch: int, world: int, rank: int, microbatch: int = 0) -> np.ndarray:
    """The rows of the global batch that ``rank`` trains on, in its order.

    The step splits the global batch of ``batch`` rows into microbatches of
    ``microbatch`` rows (the whole batch when ``microbatch`` is not in
    ``(0, batch)``), as the JAX step does (``train_step.py:109-140``), and
    each rank takes its ``microbatch / world`` rows of every one: so a
    rank's k-th local microbatch is its share of the k-th global one, and
    ``world`` ranks see the microbatches one process at ``batch`` sees."""
    micro = microbatch if 0 < microbatch < batch else batch
    if batch % micro:
        raise ValueError(f"batch {batch} is not a multiple of microbatch {micro}")
    share = local_batch_size(micro, world)
    return np.concatenate([np.arange(k * micro + rank * share, k * micro + (rank + 1) * share)
                           for k in range(batch // micro)])
