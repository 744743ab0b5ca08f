"""Host-side training loop.

The subset of ``causaldiffae_tpu/training/loop.py:74-245`` that the train
CLI needs: iterate batches, move each to the device (the batch stays NHWC,
as the JAX package feeds it; the model goes NCHW inside), call the train
step, and emit one JSON record every ``log_interval`` steps with the step,
the metrics, the host-clock time per step and samples per second. The
metrics stay on the device between log lines, so only a log line waits for
the device. Checkpoints, resume and the SIGTERM save are not ported yet.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .state import TrainState, create_train_state
from .train_step import make_train_step

__all__ = ["run_training", "to_device"]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; through pinned memory to a card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def run_training(cfg, model: torch.nn.Module, diffusion, data: Iterator[Dict[str, np.ndarray]],
                 *, total_steps: int, log_interval: int,
                 device) -> Tuple[TrainState, List[dict]]:
    """Train ``model`` for ``total_steps`` steps (fewer if the LR anneal ends
    first) from a fresh state; prints each record and returns the state and
    the records."""
    state = create_train_state(cfg, model)
    step_fn = make_train_step(cfg, model, diffusion, state.optimizer)
    records = []
    t_last, step_last, samples = time.perf_counter(), state.step, 0
    while state.step < total_steps and (not cfg.lr_anneal_steps
                                        or state.step < cfg.lr_anneal_steps):
        batch = to_device(next(data), device)
        metrics = step_fn(state, batch)
        samples += batch["image"].shape[0]
        if state.step % log_interval == 0 or state.step == total_steps:
            values = {k: float(v) for k, v in metrics.items() if not k.endswith("_count")}
            now = time.perf_counter()  # float() above waited for the device
            rec = {"step": state.step, **values,
                   "step_time_s": (now - t_last) / (state.step - step_last),
                   "samples_per_s": samples / (now - t_last), "device": str(device)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            t_last, step_last, samples = now, state.step, 0
    return state, records
