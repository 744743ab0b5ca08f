"""Closed-loop training: one process trains the port as its train loop does.

Traffic parameters: ``batch`` (rows per step), ``pool_batches`` (the pool
holds that many batches of distinct rows), ``log_interval`` (the metrics are
read back every that many steps, one interval late, as ``run_training``
does), ``check_steps`` (the first steps, which the reference follows),
``warm_steps`` (more steps before the window, with the step's own draws),
``trace_after`` and ``trace_steps`` (with ``--trace 1``, the window's steps
that are profiled).

Set-up builds one training step, the port's ``make_train_step`` over
``wrap_model`` with its model and AdamW state (weights made on the card from
the seed), fed by ``make_data_iterator`` (the native loader where it builds)
through the train loop's feed, under ``determinism.pin`` as the train CLI
runs. It drives that step through its first ``check_steps`` steps on the
feed's batches with draws the benchmark makes, keeping what the reference
needs, warms up, and hands the same step to the window. End to end:
``train_samples_per_s``, every row of every step in the window over the
window's seconds, which end in ``torch.cuda.synchronize()``. Its notes give
the steps finished in each 5 s of the window and the process's CPU seconds
over the window's, so a host that stalls or slows shows where.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import pool
from benchmark.reference import model as M
from benchmark.reference import train as R


def draws(m: dict, batch: int, seed: int, n: int, device) -> List[Dict[str, torch.Tensor]]:
    """Every random draw of ``n`` steps: t, the diffusion noise, the
    representation's noise and the keep-mask."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s, ch = m["image_size"], m["in_channels"]
    out = []
    for _ in range(n):
        out.append({
            "t": torch.randint(0, m["diffusion_steps"], (batch,), generator=gen, device=device),
            "noise": torch.randn((batch, s, s, ch), generator=gen, device=device),
            "rep_noise": torch.randn((batch, m["rep_dim"]), generator=gen, device=device),
            "keep": torch.bernoulli(torch.full((batch,), 1.0 - m["drop_prob"], device=device),
                                    generator=gen),
        })
    return out


def half(d: Optional[Dict[str, torch.Tensor]]):
    """The first half of every row (a fault: half of the batch left out)."""
    return None if d is None else {k: v[: len(v) // 2] for k, v in d.items()}


class Setup:
    """The port's training step, built and driven through its first steps."""

    def __init__(self, r, fault: Optional[str] = None):
        from causaldiffae_torch.config import create_diffusion, create_model
        from causaldiffae_torch.data.loaders import make_data_iterator
        from causaldiffae_torch.ops import _build
        from causaldiffae_torch.training import create_train_state, make_train_step
        from causaldiffae_torch.training.loop import _Feed, wrap_model
        from causaldiffae_torch.utils import determinism

        self.r, tr, m = r, r.traffic, r.config["model"]
        r.phase("imports")
        self.seeds = pool.seeds(r.seed, 3)
        self.batch = tr["batch"]
        determinism.pin()
        cfg = r.port_config().replace(batch_size=self.batch, seed=self.seeds[0] % 2 ** 31,
                                      log_interval=tr["log_interval"])
        device = r.device
        if device.startswith("cuda") and cfg.use_kernels and cfg.use_bf16:
            _build.build("attention_fwd")
            _build.build("attention_bwd")
        r.phase("kernels")
        with torch.device(device):
            model = create_model(cfg, device=device)
        r.phase("model_init")
        weights = M.make_weights(m, self.seeds[0], device)
        model.load_state_dict({**weights, **M.buffers(m, device)}, strict=True)
        del weights
        r.phase("weights")
        self.names = [n for n, _ in model.named_parameters()]
        self.model = model
        self.state = create_train_state(cfg, model)
        step = make_train_step(cfg, wrap_model(cfg, model, device), create_diffusion(cfg),
                               self.state.optimizer)
        r.phase("step")
        self.step = step
        if fault == "half_batch":
            self.step = lambda state, batch, draws=None: step(state, half(batch),
                                                              draws=half(draws))
        if fault == "state_unchanged":
            self.step = self._unchanged(step)
        data = pool.image_pool(self.seeds[1], self.batch * tr["pool_batches"], m, signed=False)
        self.data = make_data_iterator(data, self.batch, seed=self.seeds[1] % 2 ** 31)
        self.kept: List[dict] = []
        self.feed = _Feed(self._recorded(), device)
        self.fault = fault
        r.phase("data")

    def _recorded(self):
        """The data iterator, keeping a copy of the first check steps'
        batches, which the reference looks up in its own pool."""
        while True:
            batch = next(self.data)
            if len(self.kept) < self.r.traffic["check_steps"]:
                self.kept.append({k: v.copy() for k, v in batch.items()})
            yield batch

    def check_steps(self) -> dict:
        """The first steps with the benchmark's draws: what the reference
        compares (each loss, the first gradient as AdamW holds it, the
        parameters and EMA after the last), copied to the host."""
        n, m = self.r.traffic["check_steps"], self.r.config["model"]
        given = draws(m, self.batch, self.seeds[2], n, self.r.device)
        out: dict = {"loss": []}
        nxt = self.feed.fetch()
        for i in range(n):
            metrics = self.step(self.state, self.feed.ready(nxt), draws=given[i])
            nxt = self.feed.fetch()
            out["loss"].append(metrics["loss"])
            if i == 0:
                out["grad"] = self._first_grad()
        out["loss"] = [float(v) for v in out["loss"]]
        params = dict(self.model.named_parameters())
        out["params"] = {k: params[k].detach().to("cpu", copy=True) for k in self.names}
        ema = next(iter(self.state.ema.values()))
        out["ema"] = {k: ema[k].to("cpu", copy=True) for k in self.names}
        self.next_batch = nxt
        self.feed.data = self.data   # the window reads the iterator itself
        self.r.phase("check_steps")
        return out

    def _unchanged(self, step):
        """The fault ``state_unchanged``: the step, then its parameters and
        EMA put back as they were."""
        def frozen(state, batch, draws=None):
            held = [t.detach().clone() for t in self.model.parameters()]
            ema = {k: {n: t.clone() for n, t in v.items()} for k, v in state.ema.items()}
            out = step(state, batch, draws=draws)
            with torch.no_grad():
                for t, h in zip(self.model.parameters(), held):
                    t.copy_(h)
                for k, v in ema.items():
                    for n, t in v.items():
                        state.ema[k][n].copy_(t)
            return out
        return frozen

    def _first_grad(self) -> Dict[str, torch.Tensor]:
        """g = m_1 / (1 - b1): AdamW's first moment after one step."""
        st, params = self.state.optimizer.state, dict(self.model.named_parameters())
        out = {}
        for k in self.names:
            s = st.get(params[k], {})
            g = s["exp_avg"] / 0.1 if "exp_avg" in s else torch.zeros_like(params[k])
            out[k] = g.to("cpu", copy=True)
        return out

    def free(self):
        """Drop the port's state, so the reference runs on a card that holds
        nothing of it."""
        for k in ("step", "state", "model", "feed", "data"):
            setattr(self, k, None)
        gc.collect()
        if self.r.device.startswith("cuda"):
            torch.cuda.empty_cache()


def feed_rows(data: Dict[str, np.ndarray], kept: List[dict]) -> Tuple[List[dict], int]:
    """The reference's batches, and how many rows the feed got wrong.

    Each row that the feed gave the port's first steps is found in the pool
    by its 8-bit content, and the reference takes the pool's own row (its
    image, ``c`` and ``y``) in its place, in the feed's order. A row is
    wrong where no pool row has its content, where its values or labels are
    not that row's, or where an earlier checked row was the same pool row:
    the loader's epoch permutation gives distinct rows."""
    images = data["image"].reshape(len(data["image"]), -1)
    where = {row.tobytes(): i for i, row in enumerate(np.rint(images * 255.0).astype(np.uint8))}
    seen, bad, batches = set(), 0, []
    for b in kept:
        idx = []
        for j, row in enumerate(b["image"].reshape(len(b["image"]), -1)):
            i = where.get(np.rint(row * 255.0).astype(np.uint8).tobytes())
            ok = (i is not None and i not in seen
                  and np.allclose(row, images[i], rtol=0.0, atol=1e-6)
                  and all(k in b and np.array_equal(b[k][j], data[k][i])
                          for k in data if k != "image"))
            bad += int(not ok)
            idx.append(0 if i is None else i)
            seen.add(i)
        batches.append({k: v[np.asarray(idx)] for k, v in data.items()})
    return batches, bad


def reference(r, kept: List[dict], cast=M.identity):
    """The reference's steps from the same weights and draws as the port's
    first steps, on the pool's rows that the feed gave them (``cast``: the
    reference one precision down, the control); the weights before them;
    and the count of rows the feed got wrong (:func:`feed_rows`)."""
    m, device, tr = r.config["model"], r.device, r.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = pool.seeds(r.seed, 3)
    P0 = {**M.make_weights(m, s[0], device), **M.buffers(m, device)}
    data = pool.image_pool(s[1], tr["batch"] * tr["pool_batches"], m, signed=False)
    rows, bad = feed_rows(data, kept)
    del data
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in rows]
    given = draws(m, tr["batch"], s[2], len(kept), device)
    hook = R.checkpointed if device.startswith("cuda") else None
    out = R.train(P0, m, r.config["adjacency"], batches, given, cast, hook)
    return out, {k: P0[k] for k in M.param_shapes(m)}, bad


def reference_numbers(r, kept: List[dict], prog: dict) -> Dict[str, float]:
    ref, start, bad = reference(r, kept)
    return {**R.compare(r.config["model"], ref, prog, start), "feed_rows_bad": float(bad)}


def run(r) -> dict:
    tr = r.traffic
    s = Setup(r, r.fault)
    prog = s.check_steps()
    step, state, feed, batch = s.step, s.state, s.feed, s.batch
    from causaldiffae_torch.training.loop import _start_readback

    nxt = s.next_batch
    metrics = None
    for _ in range(tr["warm_steps"]):
        metrics = step(state, feed.ready(nxt))
        nxt = feed.fetch()
    _, _, done = _start_readback(metrics)   # the readback's pinned buffer
    if done is not None:
        done.synchronize()
    r.phase("warm")

    failed, pending, steps = 0, None, 0
    counts = {"steps": tr["trace_steps"]}
    r.open_window()
    t0 = time.perf_counter()
    cpu0 = time.process_time()
    stamps: List[float] = []
    profiled = None
    while time.perf_counter() - t0 < r.seconds:
        if r.trace and steps == tr["trace_after"]:
            profiled = r.profiled(counts)
            profiled.__enter__()
        with r.span("bench.data.ready"):
            ready = feed.ready(nxt)
        with r.span("bench.step"):
            metrics = step(state, ready)
        with r.span("bench.data.fetch"):
            nxt = feed.fetch()
        steps += 1
        stamps.append(time.perf_counter() - t0)
        if state.step % tr["log_interval"] == 0:
            with r.span("bench.readback"):
                started = _start_readback(metrics)
                if pending is not None:
                    failed += _failed(*pending)
                pending = started
        if profiled is not None and steps == tr["trace_after"] + tr["trace_steps"]:
            profiled.__exit__(None, None, None)
            profiled = None
    if profiled is not None:   # the window closed first
        counts["steps"] = steps - tr["trace_after"]
        profiled.__exit__(None, None, None)
    r.close_window()
    elapsed = time.perf_counter() - t0
    cpu = time.process_time() - cpu0
    if pending is not None:
        failed += _failed(*pending)
    kept = s.kept
    s.free()
    del step, state, feed, metrics, nxt
    numbers = reference_numbers(r, kept, prog)
    plain = max(steps - (tr["trace_steps"] if r.profiled_s else 0), 1)
    host = {"wall_ms_per_step": 1e3 * (elapsed - r.profiled_s) / plain,
            "data_wait_ms": 1e3 * (r.host_s.get("bench.data.fetch", 0.0)
                                   + r.host_s.get("bench.data.ready", 0.0)) / plain}
    slices = [0] * max(math.ceil(elapsed / 5.0), 1)
    for t in stamps:
        slices[min(int(t // 5.0), len(slices) - 1)] += 1
    notes = {"window_steps_per_5s": " ".join(map(str, slices)),
             "window_cpu_share": f"{cpu / elapsed:.4f}"}
    return {"attempted": steps, "failed": failed, "numbers": numbers, "host": host,
            "e2e": {"train_samples_per_s": steps * batch / elapsed}, "notes": notes}


def _failed(keys, host, done) -> int:
    """1 where the read-back step has a non-finite loss or was skipped."""
    if done is not None:
        done.synchronize()
    vals = dict(zip(keys, host.tolist()))
    return int(not math.isfinite(vals["loss"]) or vals.get("step_skipped", 0.0) > 0)
