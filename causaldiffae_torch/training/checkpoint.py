"""Checkpoint / resume with one ``torch.save`` file per step.

The port's counterpart of ``causaldiffae_tpu/training/checkpoint.py:23-52``,
with the same surface: ``latest_step``, ``save(step, state)``,
``restore(state)`` and keep-3. A file holds the whole ``TrainState``: the
model's ``state_dict`` (with the encoder's BatchNorm buffers), the AdamW
``state_dict``, every EMA copy, the sampler's state, the step and, from a
manager given one, the config the state was trained with (its fields), from
which the serve CLI rebuilds the model and the diffusion. A save
writes a temporary name and ``os.replace``-s it into place, so a save cut
off by a signal leaves the previous checkpoint whole. ``restore`` loads onto
the state's own tensors, so onto the model's device. Under data
parallelism the primary rank writes and every rank restores the same file.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ..parallel.collectives import barrier, is_primary
from .state import TrainState

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _sampler_to_tensors(sampler_state):
    return None if sampler_state is None else {k: torch.from_numpy(np.array(v))
                                               for k, v in sampler_state.items()}


def _sampler_from_tensors(saved):
    return None if saved is None else {k: v.numpy().copy() for k, v in saved.items()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, config=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.config = config
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> str:
        """Write ``state`` as ``step``'s checkpoint; keep the newest ``max_to_keep``.

        Under data parallelism every rank holds the same state: the primary
        writes it, and every rank returns once it is in place."""
        path = self._path(step)
        if is_primary():
            self._write(step, state, path)
        barrier()
        return path

    def _write(self, step: int, state: TrainState, path: str) -> None:
        payload = {
            "step": int(step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "sampler_state": _sampler_to_tensors(state.sampler_state),
            "config": None if self.config is None else dataclasses.asdict(self.config),
        }
        tmp = os.path.join(self.directory, f".step_{step}.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def load(self, step: Optional[int] = None) -> dict:
        """``step``'s (default: the latest) checkpoint as saved, on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default: the latest) into ``state`` in place and return it."""
        saved = self.load(step)
        if {r: sorted(e) for r, e in saved["ema"].items()} != \
                {r: sorted(e) for r, e in state.ema.items()}:
            raise KeyError(f"checkpoint EMA rates {sorted(saved['ema'])} or their parameters "
                           f"differ from the state's ({sorted(state.ema)})")
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        with torch.no_grad():
            for rate, tensors in saved["ema"].items():
                for name, value in tensors.items():
                    state.ema[rate][name].copy_(value)
        state.sampler_state = _sampler_from_tensors(saved["sampler_state"])
        state.step = int(saved["step"])
        return state
