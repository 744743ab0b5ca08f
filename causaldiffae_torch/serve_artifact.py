"""Run a serving artifact over a batch stream, without model code.

Port of ``scripts/serve.py``, the consumer half of the deployment story
(``export_serving`` is the producer): load an artifact (``serving.py``), feed
it batches from an ``.npz`` (or a synthetic stream for latency checks), write
the outputs and report first-call and steady latency. Imports torch, numpy
and ``causaldiffae_torch.serving`` alone: no model, diffusion or config code.

A fixed-batch artifact pads the stream's tail and trims it after; a
polymorphic one is chunked by ``--batch``. One batch is kept in flight:
batch i+1 is dispatched before batch i is copied to the host. The sibling
AOTInductor package is preferred; where it does not load (another card,
device type or torch), the reason is printed and the portable program
serves on the same device, reported as ``"aot": false``. Both run the
attention kernel when the manifest says ``"attention": "kernel"``, and the
norm kernels where ``"norm_nodes"`` is not 0; ``attention_launches`` and
``norm_launches`` count their forward launches in this run.

Usage:
  python -m causaldiffae_torch.serve_artifact --artifact artifacts/do.pt2 \\
      --input batch.npz --value 1.0 --out served.npz
  python -m causaldiffae_torch.serve_artifact --artifact ... --synthetic 64 --prewarm
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .ops.attention import attention_fwd
from .ops.norm_act import norm_act_fwd
from .serving import COMPILED_SUFFIX, load_artifact, load_compiled_artifact

__all__ = ["main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", required=True)
    p.add_argument("--input", default="",
                   help=".npz with arrays named per the manifest inputs (x, and y/c when the "
                        "model conditions on them)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="serve N synthetic rows instead of --input")
    p.add_argument("--value", type=float, default=None,
                   help="intervention level (counterfactual artifacts)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=None,
                   help="serving batch for a polymorphic artifact (default: the whole stream "
                        "in one call); a fixed-batch artifact takes its own")
    p.add_argument("--no_pipeline", action="store_true",
                   help="serve batches strictly one after another (one batch on the device)")
    p.add_argument("--prewarm", action="store_true",
                   help="run one batch with an off-traffic seed before the stream, so that "
                        "the first real call runs at steady speed")
    p.add_argument("--no_aot", action="store_true",
                   help="ignore a sibling <artifact>" + COMPILED_SUFFIX + " package")
    p.add_argument("--out", default="served.npz")
    args = p.parse_args(argv)
    if args.batch is not None and args.batch < 1:
        raise SystemExit(f"--batch {args.batch}: must be >= 1")
    return args


def _feed(args, by_name) -> dict:
    """The stream's arrays by input name, from --synthetic or --input."""
    if args.synthetic:
        n, feed = args.synthetic, {}
        if "x" in by_name:
            feed["x"] = np.zeros([n] + by_name["x"]["shape"][1:], np.float32)
        if "y" in by_name:
            feed["y"] = (np.arange(n) % 10).astype(np.int64)
        if "c" in by_name:
            feed["c"] = np.zeros((n, by_name["c"]["shape"][1]), np.float32)
        return feed
    if not args.input:
        raise SystemExit("one of --input / --synthetic is required")
    with np.load(args.input) as z:
        feed = {k: z[k] for k in z.files if k in by_name}
    if not feed:
        raise SystemExit(f"--input {args.input}: no arrays match the manifest inputs "
                         f"{list(by_name)}")
    if len(next(iter(feed.values()))) == 0:
        raise SystemExit(f"--input {args.input}: input stream is empty")
    return feed


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    program, aot = None, False
    compiled = args.artifact + COMPILED_SUFFIX
    if not args.no_aot and Path(compiled).exists():
        try:
            program, aot = load_compiled_artifact(compiled), True
        except Exception as e:  # noqa: BLE001 - reported, then the portable program serves
            print(f"ignoring {compiled}: {e}", flush=True)
    fn, manifest = load_artifact(args.artifact, program)
    inputs = manifest["inputs"][:-1]
    by_name = {i["name"]: i for i in inputs}
    print(f"artifact: {manifest.get('fn')} ({manifest.get('preset')}), inputs "
          f"{[i['name'] for i in manifest['inputs']]}, device {manifest['device']}, attention "
          f"{manifest['attention']}{', AOT package' if aot else ''}", flush=True)
    feed = _feed(args, by_name)
    if "value" in by_name and args.value is None:
        raise SystemExit("this artifact takes --value (counterfactual)")
    n = len(next(iter(feed.values())))
    fixed_b = manifest["batch_size"] if isinstance(manifest["batch_size"], int) else None
    if args.batch and fixed_b and args.batch != fixed_b:
        print(f"--batch {args.batch} ignored: artifact is fixed at {fixed_b}", flush=True)
    B = fixed_b or min(args.batch or n, n)
    device = torch.device(manifest["device"])

    def rows(lo):
        """Rows [lo, lo + B), the tail padded by repeating its last row."""
        part = {k: v[lo:lo + B] for k, v in feed.items()}
        pad = B - len(next(iter(part.values())))
        if pad:
            part = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)]) for k, v in part.items()}
        return [part[i["name"]] if i["name"] != "value" else np.float32(args.value)
                for i in inputs], pad

    def dispatch(lo, seed):
        call, pad = rows(lo)
        return fn(*call, seed), pad

    def harvest(out, pad):
        out = out.float().cpu().numpy()   # waits for this batch only
        return out[:B - pad] if pad else out

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    launches0, norm0 = attention_fwd.launches, norm_act_fwd.launches
    prewarm_s = None
    if args.prewarm:   # off the traffic path, with a seed no traffic call uses
        t0 = time.perf_counter()
        dispatch(0, args.seed - 1)
        sync()
        prewarm_s = time.perf_counter() - t0
    offsets = list(range(0, n, B))
    t0 = time.perf_counter()
    pending = dispatch(offsets[0], args.seed)
    sync()
    first_call_s = time.perf_counter() - t0
    outs, stamps = [], []
    for lo in offsets[1:]:
        if args.no_pipeline:
            outs.append(harvest(*pending))
            stamps.append(time.perf_counter())
            pending = dispatch(lo, args.seed + lo)
        else:   # dispatch batch i+1, then copy batch i to the host
            nxt = dispatch(lo, args.seed + lo)
            outs.append(harvest(*pending))
            stamps.append(time.perf_counter())
            pending = nxt
    outs.append(harvest(*pending))
    stamps.append(time.perf_counter())
    # stamps[0] harvests the finished first call: the steady periods are the gaps
    intervals = np.diff(stamps)
    steady = float(np.mean(intervals)) if len(intervals) else first_call_s
    p50 = float(np.median(intervals)) if len(intervals) else first_call_s
    images = np.concatenate(outs, 0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, samples=images)
    report = {
        "served": int(images.shape[0]), "batch": B, "first_call_s": first_call_s,
        "steady_batch_s": steady, "steady_batch_p50_s": p50, "imgs_per_sec": B / steady,
        "pipelined": not args.no_pipeline, "aot": aot, "out": args.out,
        "attention_launches": attention_fwd.launches - launches0,
        "norm_launches": norm_act_fwd.launches - norm0,
    }
    if prewarm_s is not None:
        report["prewarm_s"] = prewarm_s
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
