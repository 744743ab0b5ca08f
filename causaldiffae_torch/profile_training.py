"""Where the time of a train step goes, on the card.

Runs ``STEPS`` train steps of ``--preset`` (default the flagship
``morphomnist_causaldae``) at the preset's batch and image shape (random
weights from ``SEED``, every weight filled so that each block does real
work; a batch of the preset's synthetic data moved to the card each step,
as the train CLI does) under ``torch.profiler``, after ``WARMUP`` steps, and prints one JSON
line: wall and device time per step, the device's busy share (the sum of
kernel times in the profiled window over the wall time of the same steps run
without the profiler; one stream, so kernels do not overlap), kernel
launches per step, the runtime calls per step that make the host wait for
the device, peak memory, the kernels that take the most device time,
and the attention kernels by name. Without device times in the trace it says
so instead of printing a share.

Usage: python -m causaldiffae_torch.profile_training [--preset circuit_causaldae]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

STEPS = 10
WARMUP = 3
SEED = 0
TOP = 15  # kernels listed in the report
ATTENTION_KERNELS = ("attention_fwd_kernel", "attention_bwd_dq_kernel",
                     "attention_bwd_dkv_kernel")


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="morphomnist_causaldae")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .config import create_diffusion, create_model, get_config
    from .data import synthetic_dataset
    from .training import create_train_state, make_train_step
    from .training.loop import to_device
    from .utils import determinism
    from .utils.weights import fill_normal_

    determinism.pin()  # the step as the train CLI runs it

    cfg = get_config(args.preset).replace(seed=SEED)
    model = create_model(cfg, device="cuda")
    fill_normal_(model, torch.Generator().manual_seed(SEED), std=0.02)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, create_diffusion(cfg), state.optimizer)
    batch = synthetic_dataset(cfg.dataset, cfg.batch_size, seed=SEED, image_size=cfg.image_size)

    def run(n):
        for _ in range(n):
            metrics = step(state, to_device(batch, "cuda"))
        return metrics

    run(WARMUP)  # cuDNN plans, kernel builds, optimizer state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = run(STEPS)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only: a CPU op's own "device time" repeats its kernels'
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    kernels.sort(key=lambda k: -k[1])
    per_step = lambda name, us, c: {"name": name[:80], "ms_per_step": us / 1e3 / STEPS,
                                    "share_of_device_time": us / 1e3 / device_ms,
                                    "launches_per_step": c / STEPS}
    report = {
        "preset": cfg.name, "batch": cfg.batch_size, "steps": STEPS,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step": plain_wall_ms / STEPS,
        "samples_per_s": cfg.batch_size * STEPS / (plain_wall_ms / 1e3),
        "profiled_wall_ms_per_step": wall_ms / STEPS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": float(metrics["loss"]),
    }
    # runtime calls that make the host wait for the device (the window's
    # closing synchronize() is one of them)
    syncs = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CPU and "Synchronize" in e.key)
    report["host_syncs_per_step"] = (syncs - 1) / STEPS
    if device_ms > 0:
        report.update({
            "device_ms_per_step": device_ms / STEPS,
            "device_busy_share": device_ms / plain_wall_ms,
            "device_busy_share_profiled": device_ms / wall_ms,
            "kernel_launches_per_step": sum(c for _, _, c in kernels) / STEPS,
            "attention_kernels": [per_step(*k) for k in kernels
                                  if any(a in k[0] for a in ATTENTION_KERNELS)],
            "top_kernels": [per_step(*k) for k in kernels[:TOP]],
        })
    else:
        report["device_busy_share"] = "not measured: the trace holds no device times"
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
