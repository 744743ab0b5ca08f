"""Host-side training loop.

Port of ``causaldiffae_tpu/training/loop.py:74-245``: iterate batches, move
each to the device (the batch stays NHWC, as the JAX package feeds it; the
model goes NCHW inside), call the train step, log at ``log_interval`` (and
at the last step), checkpoint at ``save_interval`` and at an end off the interval, and resume
from the latest checkpoint.

- One batch in flight: batch k+1 is copied to the card on a side stream
  from pinned memory while step k runs.
- Lagged metric readback: at a log interval the step's metrics are stacked
  on the device and copied with ``non_blocking=True`` into pinned host
  memory behind a CUDA event; they are logged at the NEXT interval (or at
  the end), when the copy has long arrived, so no log line waits for the
  device. A record is stamped when its step is dispatched, so its
  ``step_time_s`` and ``samples_per_sec`` are dispatch rates that converge
  to the device's over a run.
- SIGTERM/SIGINT set a flag; the loop saves at the top of the next step and
  returns, restoring the old handlers. ``DIFFUSION_TRAINING_TEST`` in the
  environment makes it return after the first save.
- Data parallelism: under ``torch.distributed`` (``torchrun``; see
  ``parallel/``) the model runs wrapped in ``DistributedDataParallel`` and
  ``data`` yields this rank's ``batch_size / W`` rows. The metrics are
  reduced over the ranks at the log interval (one all-reduce, read back
  late as above), the primary rank alone logs and writes checkpoints, and
  every rank resumes from the same one. A signal reaches the ranks at
  different steps, so they agree on it through that reduction and stop
  together at the step after the next log interval that reads it.
- Tensor parallelism (``cfg.model_parallel = k > 1``): the ranks form the
  grid of ``parallel/grid.py``; the loop cuts the model's ResBlock conv
  pairs to this rank's shard (``parallel/partition.py``) before the
  optimizer and the EMA see them, and wraps it in DDP over its DP group
  when that has more than one rank. ``data`` then yields the data row's
  share, the same on the k ranks of a row; the metrics are reduced over the
  DP group, the signal over every rank. Checkpoints hold the whole model
  (``training/checkpoint.py``).

Each record goes to the logger (``logkv_mean``/``dumpkvs``: progress.csv,
progress.json, log.txt as configured) and, as one JSON line, to stdout. Its
``wait_data`` is the host time spent in the feed since the record before it:
the seconds of the feed's spans.

Spans (``utils/tracing.py``): ``cdae.train.data.next`` (the iterator's
``next``, the loader), ``cdae.train.data.copy`` (``pin_memory`` and the
copy's enqueue), ``cdae.train.data.ready``, ``cdae.train.readback`` (the
metrics' copy started) and ``cdae.train.readback.wait`` (waiting for it at
the next interval); the step's own are in ``train_step.py``.
"""

from __future__ import annotations

import inspect
import json
import os
import signal
import sys
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..parallel import (dp_group, dp_size, init_grid, is_primary, reduce_metrics,
                        sum_across_ranks, world_size)
from ..parallel.partition import shard_model_, unet_shard_plan
from ..utils import logger, tracing
from .checkpoint import CheckpointManager
from .state import TrainState, create_train_state
from .train_step import make_train_step

__all__ = ["run_training", "to_device", "wrap_model"]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; through pinned memory to a card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class _Feed:
    """Batches from ``data`` on ``device``, each copied ahead of its step:
    on a card the copy runs on a side stream, and ``ready`` makes the
    current stream wait for it."""

    SPANS = ("cdae.train.data.next", "cdae.train.data.copy", "cdae.train.data.ready")

    def __init__(self, data: Iterator[Dict[str, np.ndarray]], device):
        self.data = data
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def fetch(self) -> Dict[str, torch.Tensor]:
        with tracing.span("cdae.train.data.next"):
            batch = next(self.data)
        with tracing.span("cdae.train.data.copy"):
            if self.stream is None:
                return to_device(batch, self.device)
            with torch.cuda.stream(self.stream):
                return to_device(batch, self.device)

    @tracing.traced("cdae.train.data.ready")
    def ready(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for t in batch.values():
                t.record_stream(current)
        return batch


def _feed_seconds() -> float:
    spans = tracing.snapshot()["spans"]
    return sum(spans[k]["s"] for k in _Feed.SPANS if k in spans)


@tracing.traced("cdae.train.readback")
def _start_readback(metrics: Dict[str, torch.Tensor]):
    """Start copying the metrics to the host; returns (keys, host values, event)."""
    keys = sorted(k for k in metrics if not k.endswith("_count"))
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    if values.device.type != "cuda":
        return keys, values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return keys, host, done


def _wait_readback(done: Optional[torch.cuda.Event]) -> None:
    """Wait for the copy that ``_start_readback`` started (its event)."""
    if done is not None:
        with tracing.span("cdae.train.readback.wait"):
            done.synchronize()


def _note(msg: str) -> None:
    logger.log(msg)
    if is_primary():
        print(msg, file=sys.stderr, flush=True)


def wrap_model(cfg, model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` over the DP group when that
    has more than one rank, else ``model``.

    Buffers are not synced at each forward (``broadcast_buffers=False``):
    the encoder's BatchNorm statistics are the global batch's on every rank
    (``models/encoder.py``), so its running buffers agree without DDP
    rewriting them from rank 0 at each forward.
    ``find_unused_parameters`` only where a config leaves parameters out of
    the loss, or DDP's reducer would wait for their gradients: the flow
    prior built (``flow_based``) but not used (no ``causal_modeling``)."""
    if dp_size() == 1:
        return model
    dev = torch.device(device)
    ids = [dev.index if dev.index is not None else torch.cuda.current_device()] \
        if dev.type == "cuda" else None
    # torch 2.13 renames the flag (a FutureWarning for the old name)
    no_sync = ("forward_sync_buffers" if "forward_sync_buffers"
               in inspect.signature(DistributedDataParallel).parameters else "broadcast_buffers")
    return DistributedDataParallel(model, device_ids=ids, process_group=dp_group(),
                                   **{no_sync: False},
                                   find_unused_parameters=cfg.flow_based
                                   and not cfg.causal_modeling)


def run_training(cfg, model: torch.nn.Module, diffusion, data: Iterator[Dict[str, np.ndarray]],
                 *, total_steps: int, log_interval: int, device,
                 ckpt_dir: Optional[str] = None,
                 resume: bool = True) -> Tuple[TrainState, List[dict]]:
    """Train ``model`` up to step ``total_steps`` (fewer if the LR anneal ends
    first), resuming from the latest checkpoint in ``ckpt_dir`` unless
    ``resume`` is false; returns the state and the logged records.

    Weights already in ``model`` (from ``--init_from``) seed the state, EMA
    copies included; a checkpoint, when there is one, replaces them. Each
    checkpoint records ``cfg``. Under ``torch.distributed`` every rank calls
    this with the same model and config and its share of the data; with
    ``cfg.model_parallel > 1`` the model is cut to this rank's shard in
    place (it must not be sharded yet).
    """
    grid = init_grid(cfg.model_parallel)
    if grid.tp > 1:
        shard_model_(model, unet_shard_plan(model, grid.tp))
    state = create_train_state(cfg, model)
    ckpt = CheckpointManager(ckpt_dir, config=cfg) if ckpt_dir else None
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(state)
        _note(f"resumed from checkpoint at step {state.step}")
    resume_step = state.step
    step_fn = make_train_step(cfg, wrap_model(cfg, model, device), diffusion, state.optimizer)
    agree = world_size() > 1  # on a signal, through the reduced metrics
    batch_size = cfg.batch_size
    records: List[dict] = []
    pending = None   # (step, stamp, readback) of the last interval, not yet logged
    stop = []        # the ranks agreed that one of them was signalled
    t_start = last = time.perf_counter()
    last_step = resume_step
    fed = _feed_seconds()

    def log_pending():
        nonlocal pending, last, last_step, fed
        if pending is None:
            return
        at_step, stamp, (keys, host, done) = pending
        pending = None
        _wait_readback(done)
        for k, v in zip(keys, host.tolist()):
            if k == "signalled":
                if v > 0:
                    stop.append(at_step)
                continue
            logger.logkv_mean(k, v)
        logger.logkv("step", at_step)
        logger.logkv("samples", at_step * batch_size)
        logger.logkv("samples_per_sec", (at_step - resume_step) * batch_size
                     / max(stamp - t_start, 1e-9))
        logger.logkv("step_time_s", (stamp - last) / max(at_step - last_step, 1))
        now = _feed_seconds()
        logger.logkv("wait_data", now - fed)
        last, last_step, fed = stamp, at_step, now
        rec = {**logger.dumpkvs(), "device": str(device)}
        records.append(rec)
        if is_primary():
            print(json.dumps(rec), flush=True)

    def save():
        ckpt.save(state.step, state)
        _note(f"saved checkpoint at step {state.step}")

    preempted = []
    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, lambda signum, frame: preempted.append(signum))
        except ValueError:  # not the main thread
            pass
    try:
        feed = _Feed(data, device)
        next_batch = feed.fetch()
        while state.step < total_steps and (not cfg.lr_anneal_steps
                                            or state.step < cfg.lr_anneal_steps):
            if stop or (preempted and not agree):
                _note("preemption signal received - checkpointing and exiting")
                log_pending()
                if ckpt is not None:
                    save()
                return state, records
            metrics = step_fn(state, feed.ready(next_batch))
            next_batch = feed.fetch()
            if state.step % log_interval == 0 or state.step == total_steps:
                stamp = time.perf_counter()
                reduced = reduce_metrics(metrics, dp_group())
                if agree:  # every rank's, the TP ranks of a row included
                    reduced["signalled"] = sum_across_ranks(torch.full(
                        (), float(bool(preempted)), device=metrics["loss"].device))
                started = (state.step, stamp, _start_readback(reduced))
                log_pending()
                pending = started
            if ckpt is not None and state.step % cfg.save_interval == 0:
                save()
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    log_pending()
                    return state, records
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    log_pending()
    if ckpt is not None and state.step % cfg.save_interval != 0:
        save()
    return state, records
