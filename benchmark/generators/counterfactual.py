"""Counterfactual requests from one client that waits for each answer.

Traffic parameters: ``batch`` (images per request), ``pool`` (images the
requests draw from), ``sampler`` and ``sample_steps`` (the chain, as
``serve.py`` takes them), ``value_range`` (each request's do() value is
drawn uniformly over it), ``check_requests`` and ``check_among`` (how many
requests the reference checks, drawn from the seed among the first
``check_among``), ``trace_after`` and ``trace_requests`` (with ``--trace
1``, the window's requests that are profiled).

Each request is ``batch`` images of the pool with their class labels and one
do(variable = value), the variable drawn from all the configuration's
variables; it carries its two draws (the representation's noise and the
abduction noise). It is answered by the port's ``make_counterfactual_fn``
as ``serve.py`` builds it: q_sample abduction at the configuration's
``abduction_t``, no guidance, one function per variable, all built and
warmed in set-up. A request is timed on the host from its send (its arrays
leave the host) to its answer (copied back, so synchronised). End to end:
``cf_latency_p90_s``, the 90th percentile over every request answered in
the window. Each request's latency goes to stderr.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import pool
from benchmark.reference import chain as C
from benchmark.reference import model as M


def p90(values: List[float]) -> float:
    """The 90th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90))


class Requests:
    """The request stream of one seed: request k is the same in every run."""

    def __init__(self, r):
        m, tr = r.config["model"], r.traffic
        s = pool.seeds(r.seed, 4)
        self.weight_seed, self.noise_seed = s[0], s[3]
        self.pool = pool.image_pool(s[1], tr["pool"], m, signed=True)
        self.rng = np.random.default_rng(s[2])
        self.m, self.tr, self.device = m, tr, r.device
        lo, hi = tr["value_range"]
        self.lo, self.hi = lo, hi

    def make(self, k: int) -> dict:
        """Request ``k``: host arrays x, y, and its variable, value and draws."""
        m, tr = self.m, self.tr
        idx = self.rng.choice(len(self.pool["image"]), tr["batch"], replace=False)
        req = {"x": self.pool["image"][idx], "var": int(self.rng.integers(m["n_vars"])),
               "value": float(self.rng.uniform(self.lo, self.hi))}
        if m["class_cond"]:
            req["y"] = self.pool["y"][idx]
        gen = torch.Generator(device=self.device).manual_seed(self.noise_seed + k)
        B, s = tr["batch"], m["image_size"]
        req["rep_noise"] = torch.randn((B, m["rep_dim"]), generator=gen, device=self.device)
        req["abduction_noise"] = torch.randn((B, s, s, m["in_channels"]), generator=gen,
                                             device=self.device)
        return req


def on_device(req: dict, device) -> dict:
    out = dict(req)
    out["x"] = torch.from_numpy(req["x"]).to(device)
    if "y" in req:
        out["y"] = torch.from_numpy(req["y"]).to(device)
    return out


class Port:
    """The port's model and one counterfactual function per variable, with a
    span (and, for the checked requests, a record of its inputs) around each
    UNet call."""

    def __init__(self, r, fault: Optional[str] = None):
        from causaldiffae_torch.config import create_diffusion, create_model
        from causaldiffae_torch.evals.counterfactual import make_counterfactual_fn
        from causaldiffae_torch.ops.attention import prepare_forward

        self.r, tr = r, r.traffic
        r.phase("imports")
        cfg = r.port_config()
        m = r.config["model"]
        with torch.device(r.device):
            model = create_model(cfg, device=r.device)
        r.phase("model_init")
        weights = M.make_weights(m, pool.seeds(r.seed, 4)[0], r.device)
        model.load_state_dict({**weights, **M.buffers(m, r.device)}, strict=True)
        del weights
        model.eval()
        r.phase("weights")
        if cfg.use_kernels and cfg.use_bf16:
            prepare_forward(r.device)
        diffusion = create_diffusion(cfg, eval_mode=True)
        self.fns = [make_counterfactual_fn(cfg, model, diffusion, intervene_var=v,
                                           w=cfg.guidance_w, sampler=tr["sampler"],
                                           sample_steps=tr["sample_steps"])
                    for v in range(m["n_vars"])]
        r.phase("chains")
        self.model, self.record, self.calls, self.restore = model, None, 0, []
        denoise = model.denoise
        span = r.span

        def timed(x, t, y=None, c=None, z=None, **kw):
            if self.record is not None:
                self.record["states"].append(x)
            self.calls += 1
            with span("bench.unet_call"):
                return denoise(x, t, y=y, c=c, z=z, **kw)

        model.denoise = timed
        self.fault = fault
        if fault == "step_unchanged":
            self._skip_one_step()

    def _skip_one_step(self):
        """The fault ``step_unchanged``: the chain's middle step returns its state."""
        import causaldiffae_torch.diffusion.sampling as S

        run = S._run

        def patched(diffusion, step, carry, xs, traceable):
            n = xs[0].shape[0]
            count = [0]

            def skipping(c, x):
                count[0] += 1
                return c if count[0] == n // 2 else step(c, x)
            return run(diffusion, skipping, carry, xs, traceable)
        S._run = patched
        self.restore.append(lambda: setattr(S, "_run", run))

    def answer(self, req: dict, record: bool = False) -> torch.Tensor:
        """The port's answer to a request on the device; its inputs recorded."""
        self.record = {"states": []} if record else None
        cond = {"y": req["y"]} if "y" in req else {}
        out = self.fns[req["var"]](req["x"], cond, req["value"],
                                   abduction_noise=req["abduction_noise"],
                                   rep_noise=req["rep_noise"])
        if self.fault == "answer_altered":
            out = out.clone()
            out[0] += 0.1
        if record:
            self.record["answer"] = out
        return out

    def free(self):
        for undo in self.restore:
            undo()
        self.fns, self.model, self.record = None, None, None
        gc.collect()
        if self.r.device.startswith("cuda"):
            torch.cuda.empty_cache()


def reference_numbers(r, checked: Dict[int, dict], reqs: "Requests",
                      cast=None) -> Dict[str, float]:
    """The worst ``step_gap`` over the checked requests. With
    ``cast`` (the control) the answers are the reference's own at that
    precision instead of the port's."""
    m, tr, device = r.config["model"], r.traffic, r.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = {**M.make_weights(m, reqs.weight_seed, device), **M.buffers(m, device)}
    ch = C.Chain(m, int(m["eval_timestep_respacing"]), tr["sample_steps"], m["abduction_t"], device)
    worst = {"step_gap": 0.0}
    if not checked:
        return {k: float("inf") for k in worst}
    for k, (req, got) in sorted(checked.items()):
        req = on_device(req, device)
        if cast is not None:
            with torch.no_grad():
                got = ch.run(P, m, r.config["adjacency"], req, cast)
        nums = C.check(ch, P, m, r.config["adjacency"], req, got)
        for name, v in nums.items():
            worst[name] = max(worst[name], v if math.isfinite(v) else float("inf"))
    return worst


def run(r) -> dict:
    tr = r.traffic
    reqs = Requests(r)
    r.phase("pool")
    port = Port(r, r.fault)
    sample = set(np.random.default_rng(reqs.noise_seed).choice(
        tr["check_among"], min(tr["check_requests"], tr["check_among"]), replace=False).tolist())
    for var in range(r.config["model"]["n_vars"]):   # every function warmed
        warm = on_device(reqs.make(-1 - var), r.device)
        warm["var"] = var
        port.answer(warm).cpu()
    r.phase("warm")

    latencies, plain, checked, failed, k = [], [], {}, 0, 0
    counts = {"requests": tr["trace_requests"]}
    r.open_window()
    t0 = time.perf_counter()
    profiled = None
    while time.perf_counter() - t0 < r.seconds:
        if r.trace and k == tr["trace_after"]:
            profiled = r.profiled(counts)
            profiled.__enter__()
            calls0 = port.calls
        req = reqs.make(k)
        sent = time.perf_counter()
        with r.span("bench.request"):
            dev = on_device(req, r.device)
            out = port.answer(dev, record=k in sample)
            answer = out.cpu()
        latencies.append(time.perf_counter() - sent)
        if profiled is None:
            plain.append(latencies[-1])
        failed += int(not torch.isfinite(answer).all())
        if k in sample:
            checked[k] = (req, port.record)
        k += 1
        if profiled is not None and k == tr["trace_after"] + tr["trace_requests"]:
            counts["unet_calls"] = port.calls - calls0
            profiled.__exit__(None, None, None)
            profiled = None
    if profiled is not None:   # the window closed first
        counts["requests"] = k - tr["trace_after"]
        counts["unet_calls"] = port.calls - calls0
        profiled.__exit__(None, None, None)
    r.close_window()
    print("latencies_ms " + " ".join(f"{1e3 * v:.1f}" for v in latencies), file=sys.stderr)
    port.free()
    numbers = reference_numbers(r, checked, reqs)
    calls = r.host_n.get("bench.unet_call", 0)
    host = {"wall_ms_per_request": 1e3 * sum(plain) / max(len(plain), 1),
            "host_ms_per_unet_call": 1e3 * r.host_s.get("bench.unet_call", 0.0) / max(calls, 1)}
    return {"attempted": k, "failed": failed, "numbers": numbers, "host": host,
            "e2e": {"cf_latency_p90_s": p90(latencies)}}
