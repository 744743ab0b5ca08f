"""Megatron sharding of the UNet's ResBlock conv pairs over the TP group.

The port's counterpart of ``causaldiffae_tpu/parallel/partition.py:51-95,
151-167``. The rule is the JAX package's, data-driven: a ResBlock is
sharded iff its output width ``cout`` divides by the TP size and its
``out_layers.3`` takes ``cout`` channels in. Then

- ``in_layers.2`` (Cin -> Cout): weight and bias on Cout (column parallel);
- ``out_layers.0`` (the second GroupNorm): weight and bias on C, with
  ``32 / tp`` groups per shard;
- ``out_layers.3`` (Cout -> Cout): weight on Cin (row parallel), bias whole.

Everything else stays replicated: the attention blocks (the kernels' qkv is
whole on every rank), the embeddings, the encoder and the SCM.

The port adds one condition: the second GroupNorm's groups must fall whole
inside a shard, ``(cout / tp) % (cout / 32) == 0``, that is ``tp`` divides
32. Under XLA the JAX package computes a straddling group right anyway; the
port keeps such a block replicated instead, which changes the layout and
never the result.

A shard plan names the sharded blocks and, for each sharded parameter, the
dimension it is cut on. :func:`shard_model_` cuts a model's parameters to
this rank's slice in place; :func:`gather_state_dict` and
:func:`shard_state_dict` go between a rank's shard and the full
reference-key ``state_dict`` (and any dict under the parameters' names: an
EMA copy, AdamW's moments).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.layers import ResBlock, TensorShard
from .collectives import _comm_device
from .grid import tp_group, tp_rank

__all__ = ["ShardPlan", "RESBLOCK_LEAVES", "unet_shard_plan", "count_sharded", "shard_model_",
           "gather_state_dict", "shard_state_dict"]

# a sharded ResBlock's parameters and the dimension each is cut on (torch
# layouts: a conv weight is [Cout, Cin, kh, kw])
RESBLOCK_LEAVES = {"in_layers.2.weight": 0, "in_layers.2.bias": 0,
                   "out_layers.0.weight": 0, "out_layers.0.bias": 0,
                   "out_layers.3.weight": 1}


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    tp: int
    blocks: Tuple[str, ...]      # module names of the sharded ResBlocks
    leaves: Dict[str, int]       # parameter name -> the dimension it is cut on


def _shardable(block: ResBlock, tp: int) -> bool:
    cout = block.in_layers[2].weight.shape[0]
    return (cout % tp == 0 and block.out_layers[3].weight.shape[1] == cout
            and block.out_layers[0].num_groups % tp == 0)


def unet_shard_plan(model: nn.Module, tp: int) -> ShardPlan:
    """The plan of ``model`` (a CausalUNet, on any device, the meta device
    included) at ``tp`` model ranks; at tp = 1 it shards nothing."""
    blocks = tuple(name for name, m in model.named_modules()
                   if tp > 1 and isinstance(m, ResBlock) and _shardable(m, tp))
    leaves = {f"{b}.{leaf}": dim for b in blocks for leaf, dim in RESBLOCK_LEAVES.items()}
    return ShardPlan(tp, blocks, leaves)


def count_sharded(plan: ShardPlan) -> int:
    """The number of sharded parameters."""
    return len(plan.leaves)


def _cut(value: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    n = value.shape[dim] // tp
    return value.narrow(dim, rank * n, n).clone()


@torch.no_grad()
def shard_model_(model: nn.Module, plan: ShardPlan, rank: Optional[int] = None,
                 group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    """Cut ``model``'s sharded parameters to TP rank ``rank``'s slice (default:
    this process's, ``grid.tp_rank()``) in place, and turn each sharded
    block's TP path on over ``group`` (default ``grid.tp_group()``). Call it
    before the optimizer, the EMA and DDP see the parameters. Returns the
    model, which keeps the plan as ``shard_plan``."""
    rank = tp_rank() if rank is None else rank
    group = tp_group() if group is None else group
    for name in plan.blocks:
        block = model.get_submodule(name)
        width = block.out_channels // plan.tp
        for leaf, dim in RESBLOCK_LEAVES.items():
            owner, attr = leaf.rsplit(".", 1)
            module = block.get_submodule(owner)
            setattr(module, attr, nn.Parameter(_cut(getattr(module, attr), dim, rank, plan.tp)))
        block.out_layers[0].num_groups //= plan.tp
        block.tp = TensorShard(group, rank, plan.tp, slice(rank * width, (rank + 1) * width))
    model.shard_plan = plan
    return model


def shard_state_dict(full: Mapping[str, torch.Tensor], plan: ShardPlan,
                     rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """TP rank ``rank``'s shard (default: this process's) of a full
    reference-key dict; keys the plan does not shard pass through."""
    rank = tp_rank() if rank is None else rank
    return {k: _cut(v, plan.leaves[k], rank, plan.tp) if k in plan.leaves else v
            for k, v in full.items()}


def gather_state_dict(shard: Mapping[str, torch.Tensor], plan: ShardPlan,
                      group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """The full reference-key dict from every TP rank's ``shard`` (an
    all-gather over ``group``, default ``grid.tp_group()``, that every rank of
    the group calls); keys the plan does not shard pass through. The
    gathered tensors come back on the device the collective runs on."""
    group = tp_group() if group is None else group
    out = dict(shard)
    for k in shard:
        if k not in plan.leaves:
            continue
        part = shard[k].detach().to(_comm_device()).contiguous()
        parts = [torch.empty_like(part) for _ in range(plan.tp)]
        dist.all_gather(parts, part, group=group)
        out[k] = torch.cat(parts, dim=plan.leaves[k])
    return out
