"""Bit-reproducible runs on the card.

:func:`pin` holds cuDNN to deterministic algorithms and turns its autotuner
off. Without it, two runs from the same seed and weights can end apart on an
H100: where TF32 is off for convolutions, cuDNN picks fp32 backward
algorithms whose sums run in another order each run, and the evaluation's
probes (fp32 convolutions) then differ from run to run, and the FID read
from them with it (``chip_smoke.py``'s repeatability phase shows it by
undoing the pin). The train CLI, the evaluation CLIs' start-up and
``profile_training`` call it; on the CPU it changes nothing. The JAX
package's reductions on its TPU give the same bits each run, so this keeps
the port to the reference's behaviour and adds no option.

:func:`differences` compares two nested states (checkpoints, state dicts)
tensor by tensor, bit for bit.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["pin", "tensors", "differences"]


def pin() -> None:
    """cuDNN: deterministic algorithms, no autotuning (process-wide)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def tensors(obj, path=""):
    """``(path, tensor)`` of every tensor in nested dicts/lists/tuples."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from tensors(obj[k], f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from tensors(v, f"{path}/{i}")


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits: a floating tensor viewed as integers of its width."""
    return x.view(_INT_OF_SIZE[x.element_size()]) if x.is_floating_point() else x


def differences(a, b) -> Dict[str, float]:
    """The tensors of two nested dicts/lists/tuples that are not bit-equal,
    by path (``/model/conv.weight``), each with its max |a - b| (inf where
    the shapes or dtypes differ). Raises KeyError when the two hold tensors
    at different paths; non-tensor leaves are not compared. Empty when
    every tensor is bit-equal.
    """
    left, right = dict(tensors(a)), dict(tensors(b))
    if left.keys() != right.keys():
        raise KeyError(f"the states hold different tensors: only in the first "
                       f"{sorted(left.keys() - right.keys())[:5]}, only in the second "
                       f"{sorted(right.keys() - left.keys())[:5]}")
    out = {}
    for path, x in left.items():
        y = right[path]
        if x.shape != y.shape or x.dtype != y.dtype:
            out[path] = float("inf")
        elif not torch.equal(_bits(x.detach()), _bits(y.detach())):
            out[path] = float((x.detach().double() - y.detach().double()).abs().max().cpu())
    return out
