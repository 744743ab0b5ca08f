"""Where the time of a counterfactual chain goes, on the card.

Runs ``STEPS`` DDIM steps of the chain of ``--preset`` (default the
flagship ``morphomnist_causaldae``) at batch ``BATCH`` from the preset's
synthetic data, with the class labels, context and representation it
conditions on (random weights from ``SEED``; every weight filled, so that
each block does real work) under ``torch.profiler``, and prints one JSON line: wall
and device time per UNet call, the device's busy share (the sum of kernel
times in the profiled window over the wall time of the same steps run
without the profiler; one stream, so kernels do not overlap) and the
kernels that take the most device time. Without device times in the trace
it says so instead of printing a share. Beside them, ``spans``: the
program's own spans (``utils/tracing.py``), self ms per UNet call by span
over the same steps run without the profiler (``cdae.unet.denoise``); the
UNet calls, by which every figure is divided, are those its counter
``cdae.unet.calls`` counted in those steps.

Usage: python -m causaldiffae_torch.profile_serving [--preset circuit_causaldae]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

BATCH = 16
STEPS = 20
SEED = 0
TOP = 12  # kernels listed in the report


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="morphomnist_causaldae")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from .config import create_diffusion, create_model, get_config
    from .data import synthetic_dataset
    from .training.loop import to_device
    from .utils import tracing
    from .utils.weights import fill_normal_

    cfg = get_config(args.preset)
    model = create_model(cfg, device="cuda")
    fill_normal_(model, torch.Generator().manual_seed(SEED), std=0.02)
    diffusion = create_diffusion(cfg, eval_mode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B = BATCH
    data = to_device(synthetic_dataset(cfg.dataset, B, seed=SEED, image_size=cfg.image_size),
                     "cuda")
    x = data["image"] * 2 - 1
    cond = {"y": data.get("y") if cfg.class_cond else None,
            "c": data.get("c") if cfg.context_cond else None,
            "z": torch.randn(B, cfg.rep_dim, generator=gen, device="cuda") if cfg.rep_cond else None}
    model_fn = lambda xx, tt: model.denoise(xx, tt, **cond)

    def chain(n):
        xx = x
        for t in range(diffusion.num_timesteps - 1, diffusion.num_timesteps - 1 - n, -1):
            tt = torch.full((B,), t, dtype=torch.long, device="cuda")
            xx = diffusion.ddim_sample(model_fn, xx, tt)["sample"]
        return xx

    with torch.inference_mode():
        chain(3)  # warm-up: cuDNN plans, kernel build
        torch.cuda.synchronize()
        tracing.reset()
        t0 = time.perf_counter()
        chain(STEPS)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        snap = tracing.snapshot()
        calls = snap["counters"]["cdae.unet.calls"]
        spans = tracing.span_table(snap, calls)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chain(STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = tracing.device_ops(prof)
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    kernels.sort(key=lambda k: -k[1])
    report = {
        "preset": cfg.name, "batch": B, "unet_calls": calls,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_unet_call": plain_wall_ms / calls,
        "profiled_wall_ms_per_unet_call": wall_ms / calls,
        "spans": spans,
    }
    if device_ms > 0:
        report.update({
            "device_ms_per_unet_call": device_ms / calls,
            "device_busy_share": device_ms / plain_wall_ms,
            "device_busy_share_profiled": device_ms / wall_ms,
            "kernel_launches_per_unet_call": sum(c for _, _, c in kernels) / calls,
            "top_kernels": [{"name": name[:80], "ms_per_unet_call": us / 1e3 / calls,
                             "share_of_device_time": us / 1e3 / device_ms,
                             "launches_per_unet_call": c / calls}
                            for name, us, c in kernels[:TOP]],
        })
    else:
        report["device_busy_share"] = "not measured: the trace holds no device times"
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
