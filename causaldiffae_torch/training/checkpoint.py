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

Under tensor parallelism (a model cut by ``parallel.shard_model_``) the
file is still the whole model's, a tp = 1 file, as the JAX package's orbax
checkpoint restores into any sharding: on save the ranks of the first data
row gather the params, AdamW's moments and every EMA copy from their TP
group into the full reference-key state and the primary writes it;
``restore`` cuts the full state to the rank's shard. So a checkpoint
resumes at any TP size, and the serve and evaluation CLIs load it as any
other.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ..parallel.collectives import barrier, is_primary
from ..parallel.grid import dp_rank
from ..parallel.partition import gather_state_dict, shard_state_dict
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
        writes it, and every rank returns once it is in place. Under tensor
        parallelism the primary's TP group gathers the full state first."""
        path = self._path(step)
        plan = _plan(state)
        full = _gather(state, plan) if plan is not None and dp_rank() == 0 else None
        if is_primary():
            self._write(step, state, path, full)
        barrier()
        return path

    def _write(self, step: int, state: TrainState, path: str, full=None) -> None:
        model, optimizer, ema = full or (state.model.state_dict(),
                                         state.optimizer.state_dict(), state.ema)
        payload = {
            "step": int(step),
            "model": model,
            "optimizer": optimizer,
            "ema": ema,
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
        """Load ``step`` (default: the latest) into ``state`` in place and
        return it; a sharded model takes its rank's cut of the full state."""
        saved = self.load(step)
        plan = _plan(state)
        if plan is not None:
            saved = _shard(saved, state, plan)
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


def _plan(state: TrainState):
    plan = getattr(state.model, "shard_plan", None)
    return plan if plan is not None and plan.leaves else None


def _moments(optimizer_sd: dict, state: TrainState, fn) -> dict:
    """``optimizer_sd`` with ``fn`` applied to each parameter's moments, as a
    dict under the parameters' names (the AdamW state is indexed by the
    parameters' order, that of ``named_parameters``)."""
    names = [n for n, _ in state.model.named_parameters()]
    per = optimizer_sd["state"]
    moments = {k: {names[i]: s[k] for i, s in per.items()} for k in ("exp_avg", "exp_avg_sq")}
    moments = {k: fn(v) for k, v in moments.items()}
    out = {i: {**s, **{k: moments[k][names[i]] for k in moments}} for i, s in per.items()}
    return {**optimizer_sd, "state": out}


def _gather(state: TrainState, plan):
    """(model, optimizer, EMA) state of the whole model, from this rank's TP group."""
    return (gather_state_dict(state.model.state_dict(), plan),
            _moments(state.optimizer.state_dict(), state,
                     lambda d: gather_state_dict(d, plan)),
            {r: gather_state_dict(e, plan) for r, e in state.ema.items()})


def _shard(saved: dict, state: TrainState, plan) -> dict:
    """A saved full state cut to this rank's shard."""
    return {**saved, "model": shard_state_dict(saved["model"], plan),
            "optimizer": _moments(saved["optimizer"], state,
                                  lambda d: shard_state_dict(d, plan)),
            "ema": {r: shard_state_dict(e, plan) for r, e in saved["ema"].items()}}
