"""A tiny copy of the benchmark for CPU tests: the harness's files, with
small configurations, traffic and limits of its own in a directory of the
test's, so the tests drive the whole run without a card.

It takes any cell list: each cell a metric lists stands for the tiny cell of
its traffic's generator, so a cell added as data needs no edit here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

TRAIN = "tiny_train"
SERVE = "tiny_serve"
# the tiny cell that stands for every cell of each generator
TINY_CELL = {"train": TRAIN, "counterfactual": SERVE}

MODEL = {"num_channels": 32, "num_res_blocks": 1, "num_heads": 2, "attention_resolutions": "16,8",
         "rep_cond": True, "causal_modeling": True, "masking": True, "drop_prob": 0.5,
         "reparam_var_scale": 0.001, "use_scale_shift_norm": True, "use_bf16": True,
         "use_kernels": True, "learn_sigma": False, "dropout": 0.0, "flow_based": False,
         "diffusion_steps": 1000, "noise_schedule": "linear", "lr": 0.0001, "weight_decay": 0.0,
         "ema_rate": "0.9999", "kl_anneal_steps": 50000, "schedule_sampler": "uniform",
         "eval_timestep_respacing": "250", "abduction_t": 249, "clip_denoised": True,
         "image_size": 28}
# one configuration for both tiny cells: at 28 x 28 the four-variable
# encoder's last convolution has a 1 x 1 input, whose bf16 backward on the
# CPU reads uninitialised memory now and then; the full-width cells never
# reach it (96 -> 2 x 2)
CONFIGS = {
    "tiny_morpho": {"preset": "morphomnist_causaldae", "adjacency": [[0.0, 1.0], [0.0, 0.0]],
                    "model": dict(MODEL, dataset="morphomnist", in_channels=1, rep_dim=16,
                                  n_vars=2, class_cond=True, batch_size=4)},
}
TRAFFIC = {
    "tiny_train": {"generator": "train", "batch": 4, "pool_batches": 4, "log_interval": 2,
                   "check_steps": 3, "warm_steps": 1, "trace_after": 1, "trace_steps": 2},
    "tiny_cf": {"generator": "counterfactual", "batch": 2, "pool": 16, "sampler": "dpm++",
                "sample_steps": 4, "value_range": [-1.0, 1.0], "check_requests": 2,
                "check_among": 2, "trace_after": 0, "trace_requests": 1},
}
# set from tiny runs on the CPU (seeds 1-2, the bf16 port against the fp8
# control): loss 4.2e-4 / 2.4e-3, grad 0.038 / 0.18, update 0.041 / 0.20,
# ema 0.22 / 0.33; step 0.025 / 0.085; the median leaf's gradient (seeds 1,
# 2, 5) 1.2e-3-2.1e-3 / 9.5e-3-1.8e-2
LIMITS = {
    TRAIN: {"loss_gap": 1.2e-3, "grad_gap": 0.1, "update_gap": 0.1, "ema_gap": 0.5,
            "grad_gap_median": 5e-3, "feed_rows_bad": 0},
    SERVE: {"step_gap": 0.05},
}


def tiny_cells(bench: dict) -> dict:
    """Each cell of ``bench`` whose traffic's generator has a tiny cell,
    mapped to that tiny cell."""
    out = {}
    for w in bench["workloads"]:
        path = BENCH / "traffic" / f"{w['traffic']}.json"
        generator = json.loads(path.read_text()).get("generator") if path.exists() else None
        if generator in TINY_CELL:
            out[w["name"]] = TINY_CELL[generator]
    return out


def make_root(tmp: Path, bench_json: Path = BENCH.parent / "BENCHMARK.json") -> Path:
    """A benchmark root under ``tmp`` with the tiny cells, its metrics those
    of ``bench_json``; each metric's cell list becomes the tiny cells of its
    cells, in order, each once, leaving out cells with no tiny cell."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cfg in CONFIGS.items():
        (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, tr in TRAFFIC.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for name, lim in LIMITS.items():
        (root / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench = json.loads(Path(bench_json).read_text())
    tiny = tiny_cells(bench)
    bench["configs"] = [{"name": n, "source": "tiny", "file": f"benchmark/configs/{n}.json",
                         "reduced": [], "why": "tiny"} for n in CONFIGS]
    bench["workloads"] = [
        {"name": TRAIN, "config": "tiny_morpho", "traffic": "tiny_train", "chips": 1, "why": "t"},
        {"name": SERVE, "config": "tiny_morpho", "traffic": "tiny_cf", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(dict.fromkeys(tiny[w] for w in m["workloads"] if w in tiny))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
