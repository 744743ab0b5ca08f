#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main paths through the hand-written attention kernels,
and fails loudly: counterfactual serving and training on the full-width
``morphomnist_causaldae`` preset, then train, checkpoint, resume and serve
through the train and serve CLIs on the full-width ``circuit_causaldae``
and ``pendulum_causaldae`` presets. Needs a CUDA device and the CUDA
toolkit (nvcc); imports nothing of JAX or of the JAX package. Phases:

1. environment: card name and power limit, torch and CUDA versions; TF32 off
   for matrix products and convolutions, so that the fp32 plain versions
   are full fp32;
2. build every kernel from ``causaldiffae_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all started together; then one line per kernel
   instantiation from ptxas's report (registers, spill, static and dynamic
   shared memory, blocks per SM, whether its wgmmas were serialized),
   raising where a d = 128 instantiation spills, serializes or holds fewer
   blocks per SM than its design, and where a d = 32 or 64 one moved from
   ``EARLIER_PTXAS``;
3. the forward kernel against its plain PyTorch version at the main paths'
   shapes (morphomnist at batch 16 serving and 128 training, a tail case;
   the circuit's and the pendulum's d=64 and d=128 shapes),
   its row logsumexp (lse, written only when asked for) against the plain
   lse, with times of the kernel (with and without lse), the plain version
   and the one-call library yardstick, beside the least time the card could
   take;
3b. the backward kernel, fed the forward kernel's output and lse as the
   training path feeds it, against its plain version at the training shapes
   of the three presets and a tail case: per element within 1e-4 + 1.6e-2 M
   (M the plain backward on the absolute values of its terms), no farther
   from an fp64 gradient than 1.5x the plain version, two launches bit-equal,
   with its times (and the dq and dk/dv kernels' device times per launch
   apart, from torch.profiler's kernel events), SDPA's backward time
   (forward + backward minus forward) and its bound;
4. one full-width ``denoise`` with the kernel, with the plain attention and
   with fp64 attention, on the same random weights: the kernel's eps may
   stand at most 1.5x as far from the fp64 one as the plain version's; the
   qkv each attention block hands the kernel there is held against the
   plain version too, with the softmax's sharpness printed;
5. serving: 2 batches of 16 counterfactual requests through DDIM-250 and 1
   through DPM++-25, with every kernel's launch count reset before and read
   after (no forward launch writes lse), latency per batch, images per
   second and peak memory;
6. training: one step's gradients at batch 16 with the kernels, with their
   plain versions (forward and backward) and with fp64 attention (the
   kernels' no more than 1.5x as far from the fp64 ones, RMS over all
   parameters); then 8 steps of the train CLI's loop at the preset's batch
   of 128 on the synthetic pool, with the launch counts reset before and
   read after (8 forward launches, each writing lse, and 8 backward launches
   per step), checking finite losses and grad norms, moved params (all but
   those whose gradient is exactly 0), an EMA that moved toward them and
   changed BatchNorm statistics; steady step time (host clock between
   device syncs, one per step), samples per second and peak memory;
7. ``circuit_causaldae`` at full width (128x128x3; 15 attention blocks per
   UNet call, 7 at T=256 d=64, 7 at T=64 d=128, 1 at T=16 d=128): the
   gradient check of phase 6 at batch 16 (15 forward launches, each writing
   lse, and 15 backward launches); the train CLI's ``main`` for 4 steps with
   a save every 2, then again to step 6, which must resume at step 4 and
   leave checkpoints {2, 4, 6}, with finite losses and grad norms, no
   skipped step, 15 launches of each kind per step and a progress.csv row
   per step; then the serve CLI's ``main`` from the checkpoint, 16 requests
   through DDIM-250: finite answers in [-1, 1], 15 forward launches per
   UNet call and none writing lse;
8. ``pendulum_causaldae`` at full width (96x96x4; only the middle block
   attends, T=144 d=128): the same, with 2 + 2 steps (one save, a resume)
   and DPM++-25, 1 launch of each kind per step and 1 per UNet call; its
   checkpoint is kept for phase 11;
8b. repeatability: the train CLI for 2 steps twice in this process and
   twice in fresh processes, one DDIM-250 do() batch of 16 twice from the
   same checkpoint, and the evaluation's probes (the ``classifier_train``
   CLI, 2 epochs) twice in fresh processes, every tensor compared bit for
   bit (raises on any difference); then the train CLI and the probes twice
   each with the entry points' cuDNN pin undone, which shows where the
   differences the pin removes come from;
9. the effectiveness evaluation of ``morphomnist_causaldae``: 2 steps of
   the train CLI and a checkpoint, then the ``counterfactual_test`` CLI on
   it (DDIM-250, 32 samples in batches of 16, two probes trained in-process,
   FID over the probe trunk) and ``rescore_counterfactuals`` on its saved
   samples with the same probes: finite MAE, probe MSE and FID >= 0, samples
   finite in [-1, 1], PNG grids with the right size, the rescore within 1e-5
   (relative) of each MAE, and 8 forward launches per UNet call, none with
   lse;
10. the NLL sweep (``nll`` CLI, one batch of 8 through all 1000 steps, on
   phase 9's checkpoint): total bpd finite and > 0, 8 launches per UNet
   call; ``vb_terms_bpd`` on a handful of timesteps through the kernel, the
   plain attention and fp64 attention on the same x_t (the kernel's no
   farther from fp64 than 1.5x the plain's); then 16 prior samples through
   the ``sample`` CLI with DPM++-25, finite and in [-1, 1];
11. ``pendulum_causaldae``'s effectiveness evaluation on phase 8's
   checkpoint with DPM++-25, 16 samples: four probes, one batch per
   variable, the effect variables intervened on z_post; 1 launch per UNet
   call.

Each phase prints its wall time. Prints the card line and one
``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

ATTN_SHAPES = [  # (B, T, heads, d): the serving path's two shapes first
    (16, 784, 4, 32),   # the seven ds=1 blocks
    (16, 49, 4, 64),    # the middle block
    (128, 784, 4, 32),  # the same blocks at the training batch
    (128, 49, 4, 64),
    (3, 100, 2, 64),    # query and key tails
    (2, 77, 2, 128),
    (16, 256, 4, 64),   # circuit_causaldae, serving and training: 7 blocks at ds=8,
    (16, 64, 4, 128),   # 7 at ds=16
    (16, 16, 4, 128),   # and the middle block at ds=32
    (16, 144, 4, 128),  # pendulum_causaldae's middle block, serving
    (32, 144, 4, 128),  # and training
    (8, 784, 4, 32),    # morphomnist's NLL sweep at batch 8
    (8, 49, 4, 64),
    (2, 200, 2, 128),   # a d = 128 tail past the 2-stage ring's refill
]
BWD_SHAPES = [          # the training path's two shapes first
    (128, 784, 4, 32),
    (128, 49, 4, 64),
    (3, 100, 2, 64),
    (2, 77, 2, 128),
    (16, 256, 4, 64),   # circuit_causaldae
    (16, 64, 4, 128),
    (16, 16, 4, 128),
    (32, 144, 4, 128),  # pendulum_causaldae
    (2, 200, 2, 128),   # a d = 128 tail past the ring's refill
]
BWD_KERNELS = ("attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")
# the attention launches of one UNet call of each preset (forward; the same
# count of backward launches per train step)
ATTN_PER_CALL = {"morphomnist_causaldae": 8, "circuit_causaldae": 15, "pendulum_causaldae": 1}
LSE_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 logsumexp: exp2 and sums in another order
FP64_BATCH = 16         # the fp64 gradient check runs on the first 16 batch elements
TRAIN_STEPS = 8
GRAD_BATCH = 16         # the plain and fp64 routes hold [B, 4, 784, 784] per block
# kernel vs plain: both round p and the output to bf16, at different points,
# so they may differ by two bf16 ulps (2^-6) of sum_j p_j |v_j|, the
# magnitude of the terms each output sums (ops.attention.rounding_scale);
# the absolute floor covers the fp32 sums' order. The backward rounds p, ds
# and each gradient once: one ulp (<= 2^-7) apart at a term and at the
# output is 2^-6 of M, the plain backward on the absolute values of its
# terms (ops.attention.bwd_rounding_scale).
ATTN_ATOL, ATTN_RTOL = 1e-4, 1.6e-2
SEED = 0
STD = 0.02            # every weight ~ N(0, STD^2), norm scales ~ 1 ...
SCORE_STD = 2.0       # ... but qkv projections give attention scores this std
# exponentials: 16 per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), 132 SMs at the
# 1.98 GHz boost clock. Printed beside the bound, not part of it.
PEAK_EXP = 16 * 132 * 1.98e9
# ptxas's report of the d = 32 and 64 instantiations, which carry the
# flagship preset, as the tree before the d = 128 redesign built them
# (registers, spill stores and loads, static and dynamic shared memory in
# bytes): the redesign leaves them as they were.
PTXAS_KEYS = ("registers", "spill_stores", "spill_loads", "smem_static", "smem_dynamic")
EARLIER_PTXAS = {
    "attention_fwd_kernel<32>": (94, 0, 0, 32, 25600),
    "attention_fwd_kernel<64>": (123, 0, 0, 32, 50176),
    "attention_bwd_dq_kernel<32>": (122, 0, 0, 32, 25600),
    "attention_bwd_dq_kernel<64>": (154, 0, 0, 32, 50176),
    "attention_bwd_dkv_kernel<32>": (154, 0, 0, 32, 27136),
    "attention_bwd_dkv_kernel<64>": (207, 0, 0, 32, 51712),
}
# the d = 128 designs' blocks per SM: the forward and the dq kernel run the
# Pendulum training grid of 384 blocks in one wave on 132 SMs
D128_BLOCKS_PER_SM = {"attention_fwd_kernel": 3, "attention_bwd_dq_kernel": 3,
                      "attention_bwd_dkv_kernel": 2}
# the repeatability phase: the train CLI for 2 steps and the evaluation's
# probes (2 epochs), each run twice; fresh processes get this process's TF32
# setting, and the runs that show the source get the pin undone
REPEAT_TRAIN = ["--preset", "morphomnist_causaldae", "--synthetic", "--total_steps", "2",
                "--save_interval", "2", "--log_interval", "1"]
PROBE_ARGS = ["--dataset", "morphomnist", "--factor", "-1", "--synthetic", "--epochs", "2",
              "--batch_size", "64", "--out_dir"]
TF32_OFF = ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n")
UNPIN = "import causaldiffae_torch.utils.determinism as d\nd.pin = lambda: None\n"
CLF_EPOCHS = 2        # probe epochs in the evaluation phases (the CLI's default is 100)
RESCORE_RTOL = 1e-5


class PhaseClock:
    """Prints each phase's header and, when the next one starts, its wall time
    and the peak device memory since the phase's last reset of the peak (a
    phase that resets it before its main work reports that work's peak)."""

    def __init__(self):
        self.name, self.t0 = None, 0.0

    def __call__(self, name=None):
        if self.name is not None:
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"--- phase {self.name.split('.')[0]}: {time.perf_counter() - self.t0:.1f} s "
                  f"wall, peak device memory since the last reset {peak:.3f} GB", flush=True)
        self.name, self.t0 = name, time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        if name is not None:
            print(f"\n=== {name} ===", flush=True)


def time_ms(fn, iters=20, reps=5):
    """Mean device time of one ``fn()`` call in ms.

    ``iters`` calls are captured in one CUDA graph, and CUDA events time
    ``reps`` replays of it, so the host's launch overhead (tens of
    microseconds a call, more than a small kernel takes) stays out of the
    reading. The inputs stay in the 50 MB L2 cache between calls, as they
    are on the main path, where each input was just written.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def kernel_us(fn, names, iters=20):
    """Mean device time (µs) of one launch of each kernel whose name holds
    one of ``names``, from torch.profiler's kernel events over ``iters``
    eager calls of ``fn``; a name the trace has no device time for is left
    out (where the profiler records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for n in names:
            if e.device_type == DeviceType.CUDA and n in e.key and e.count and \
                    e.self_device_time_total > 0:
                out[n] = e.self_device_time_total / e.count
    return out


def wall_ms(fn, iters=10, warmup=2):
    """Host-clock time of one ``fn()`` call in ms, ending in a device sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def build_phase(ops, _build):
    """Phase 2: every kernel built, one nvcc per source, all started together;
    then ptxas's report of each instantiation, with the dynamic shared memory
    its launch sets and the blocks per SM that allows. Raises on a d = 128
    instantiation that spills or serializes its wgmmas or holds fewer blocks
    per SM than its design, and on a d = 32 or 64 one whose registers, spill
    or shared memory moved from EARLIER_PTXAS. Returns the records by source."""
    sources = tuple(ops.KERNELS)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        builds = list(pool.map(_build.build, sources))
    report = {}
    for name, (seconds, log) in zip(sources, builds):
        print(f"nvcc csrc/{name}.cu: {seconds:.2f} s")
        recs = _build.ptxas_report(log)
        want = sorted((k, d) for k in ops.KERNELS[name] for d in ops.KERNEL_HEAD_DIMS)
        if sorted((r["kernel"], r["d"]) for r in recs) != want:
            raise AssertionError(f"ptxas reported {[r['name'] for r in recs]} for csrc/{name}.cu, "
                                 f"expected {want}:\n{log}")
        for r in recs:
            r["smem_dynamic"], r["blocks_per_sm"] = ops.launch_info(name, r["kernel"], r["d"])
            print(f"ptxas {r['kernel']}<{r['d']}>: {r['registers']} registers, spill "
                  f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded, stack "
                  f"{r['stack']} B, shared memory {r['smem_static']} B static + "
                  f"{r['smem_dynamic']} B dynamic, {r['blocks_per_sm']} blocks per SM, wgmma "
                  + (f"SERIALIZED ({r['serialized_reason']})" if r["wgmma_serialized"]
                     else "not serialized"), flush=True)
            key = f"{r['kernel']}<{r['d']}>"
            if r["d"] == 128 and (r["spill_stores"] or r["spill_loads"] or r["wgmma_serialized"]
                                  or r["blocks_per_sm"] < D128_BLOCKS_PER_SM[r["kernel"]]):
                raise AssertionError(f"{key} spills, serializes its wgmmas or holds fewer than "
                                     f"{D128_BLOCKS_PER_SM[r['kernel']]} blocks per SM")
            if r["d"] != 128 and tuple(r[k] for k in PTXAS_KEYS) != EARLIER_PTXAS[key]:
                raise AssertionError(f"{key}: {dict((k, r[k]) for k in PTXAS_KEYS)}, before "
                                     f"{dict(zip(PTXAS_KEYS, EARLIER_PTXAS[key]))}")
        report[name] = recs
    return report


def attention_bound(B, T, H, d):
    """Least time (ms) for the attention forward and what sets it.

    The larger of three times, each on its own unit: bytes, qkv read once
    and the output written once (bf16), at the HBM rate; the two products'
    4*B*H*T^2*d FLOPs at the bf16 tensor-core peak; the softmax's fp32
    operations, four per score (max, subtract, exp, row sum) and one per
    output (the final division), at the fp32 peak.
    """
    C = H * d
    bytes_s = 2 * (B * T * 3 * C + B * T * C) / PEAK_BYTES
    mma_s = 4 * B * H * T * T * d / PEAK_BF16_FLOPS
    fp32_s = (4 * B * H * T * T + B * T * C) / PEAK_FP32_FLOPS
    ops_s = max(mma_s, fp32_s)
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def softmax_sharpness(qkv, H):
    """Std of the scores and mean effective keys (1 / sum p^2) of batch 0."""
    T, d = qkv.shape[1], qkv.shape[2] // (3 * H)
    q, k, _ = qkv[0].reshape(T, H, 3 * d).split(d, dim=-1)
    s = torch.einsum("thd,shd->hts", q.float(), k.float()) / d ** 0.5
    return float(s.std()), float((1 / torch.softmax(s, -1).pow(2).sum(-1)).mean())


def exact_attention(ops, qkv, H):
    """fp64 attention on the same bf16-scaled q and k, with p and the output
    left unrounded; returns it and sum_j p_j |v_j|, both [B, T, C]."""
    B, T, d = qkv.shape[0], qkv.shape[1], qkv.shape[2] // (3 * H)
    q, k, v = qkv.reshape(B, T, H, 3 * d).split(d, dim=-1)
    scale = ops.kernel_scale(d, qkv.dtype).to(qkv.device)
    p = torch.softmax(torch.einsum("bthd,bshd->bhts", (q * scale).double(),
                                   (k * scale).double()), dim=-1)
    exact = torch.einsum("bhts,bshd->bthd", p, v.double()).reshape(B, T, H * d)
    magnitude = torch.einsum("bhts,bshd->bthd", p, v.double().abs()).reshape(B, T, H * d)
    return exact, magnitude


def exact_error(ops, qkv, H, out):
    """max |out - exact| / sum p|v|."""
    exact, magnitude = exact_attention(ops, qkv, H)
    return float(((out.double() - exact).abs() / magnitude.clamp_min(1e-12)).max())


def check_against_plain(ops, qkv, H, what):
    """Kernel vs plain version on one qkv; raises on a disagreement."""
    got = ops.attention_fwd(qkv, H)
    torch.cuda.synchronize()
    want = ops.attention_plain(qkv, H)
    err = (got.float() - want.float()).abs()
    scale = ops.rounding_scale(qkv, H)
    if not bool((err <= ATTN_ATOL + ATTN_RTOL * scale).all()) \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"attention kernel disagrees on {what}: "
                             f"max abs err {float(err.max())}")
    return float(err.max()), float((err / scale.clamp_min(1e-6)).max()), rms(want)


def check_attention(ops, B, T, H, d, gen):
    """Kernel vs plain version on one shape; returns the measured record."""
    import torch.nn.functional as F

    qkv = torch.randn(B, T, 3 * H * d, generator=gen, device="cuda").to(torch.bfloat16)
    max_abs_err, max_rel, want_rms = check_against_plain(ops, qkv, H, (B, T, H, d))
    want, want_lse = ops.attention_plain(qkv, H, True)
    n_lse = ops.attention_fwd.lse_launches
    out_nolse = ops.attention_fwd(qkv, H)
    if ops.attention_fwd.lse_launches != n_lse:
        raise AssertionError("a forward launch without lse counted as writing lse")
    out, lse = ops.attention_fwd(qkv, H, True)
    torch.cuda.synchronize()
    if not torch.equal(out, out_nolse):
        raise AssertionError(f"the forward's output on {(B, T, H, d)} changes when it writes lse")
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    lse_err = float((lse - want_lse).abs().max())
    # library yardstick: SDPA on the same q, k, v, after the same scaling
    q, k, v = qkv.reshape(B, T, H, 3 * d).split(d, dim=-1)
    scale = ops.kernel_scale(d, torch.bfloat16).cuda()
    q, k, v = ((a * s).transpose(1, 2).contiguous() for a, s in ((q, scale), (k, scale), (v, 1)))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
    sdpa_err = float((sdpa().transpose(1, 2).reshape(B, T, H * d).float() - want.float()).abs().max())
    bound_ms, bound_by = attention_bound(B, T, H, d)
    rec = {
        "shape": [B, T, H, d],
        "max_abs_err": max_abs_err,
        "ms": time_ms(lambda: ops.attention_fwd(qkv, H)),
        "ms_with_lse": time_ms(lambda: ops.attention_fwd(qkv, H, True)),
        "plain_ms": time_ms(lambda: ops.attention_plain(qkv, H), iters=5),
        "library_ms": time_ms(sdpa),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(f"attention {rec['shape']}: max_abs_err {max_abs_err:.3e} "
          f"(bound {ATTN_ATOL} + {ATTN_RTOL}*sum p|v|, max err / sum p|v| {max_rel:.3e}, "
          f"output rms {want_rms:.3e}; "
          f"sdpa vs plain {sdpa_err:.3e}), lse max abs err {lse_err:.3e}, kernel_ms "
          f"{rec['ms']:.4f} (with lse {rec['ms_with_lse']:.4f}), "
          f"plain_ms {rec['plain_ms']:.4f}, library_ms {rec['library_ms']:.4f}, "
          f"bound_us {1e3 * bound_ms:.2f} ({bound_by}), "
          f"exp_unit_us {1e6 * B * H * T * T / PEAK_EXP:.2f}", flush=True)
    return rec


def attention_bwd_bound(B, T, H, d):
    """Least time (ms) for the attention backward and what sets it.

    The larger of three times: bytes, qkv and g read once and dqkv written
    once (bf16), at the HBM rate; the five T x T products of the gradient
    (s recomputed once, dv, dp, dq, dk: 10*B*H*T^2*d FLOPs) at the bf16
    tensor-core peak; five fp32 operations per score (p's subtraction,
    dp - D, the product with p, and the row sum's product and add) at the
    fp32 peak. The kernel's further recomputation is not counted.
    """
    C = H * d
    bytes_s = 2 * (B * T * 3 * C + B * T * C + B * T * 3 * C) / PEAK_BYTES
    mma_s = 10 * B * H * T * T * d / PEAK_BF16_FLOPS
    fp32_s = 5 * B * H * T * T / PEAK_FP32_FLOPS
    ops_s = max(mma_s, fp32_s)
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def check_backward(ops, B, T, H, d, gen):
    """Backward kernel vs plain version vs fp64 on one shape; the measured record."""
    import torch.nn.functional as F

    qkv = (2 ** 0.5 * torch.randn(B, T, 3 * H * d, generator=gen, device="cuda")
           ).to(torch.bfloat16)   # scores of std ~2: a softmax far from uniform
    g = torch.randn(B, T, H * d, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = ops.attention_fwd(qkv, H, True)   # as the training path feeds it
    got = ops.attention_bwd(qkv, g, H, out, lse)
    again = ops.attention_bwd(qkv, g, H, out, lse)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"two backward launches on {(B, T, H, d)} differ")
    want = ops.attention_bwd_plain(qkv, g, H)
    scale = ops.bwd_rounding_scale(qkv, g, H)
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()) or not bool((err <= ATTN_ATOL + ATTN_RTOL * scale).all()):
        raise AssertionError(f"attention backward kernel disagrees on {(B, T, H, d)}: max abs err "
                             f"{float(err.max())}, max err / M {float((err / scale).max())}")
    n = min(B, FP64_BATCH)
    exact = ops.attention_bwd_exact(qkv[:n], g[:n], H)
    d_kernel, d_plain = rms(got[:n].double() - exact), rms(want[:n].double() - exact)
    if d_kernel > 1.5 * d_plain:
        raise AssertionError(f"attention backward kernel on {(B, T, H, d)} stands {d_kernel:.3e} "
                             f"from fp64 (RMS), the plain version {d_plain:.3e}")
    del exact
    # library yardstick: SDPA's backward on the same scaled q, k, v and g
    q, k, v = qkv.reshape(B, T, H, 3 * d).split(d, dim=-1)
    s = ops.kernel_scale(d, torch.bfloat16).cuda()
    q, k, v = ((a * f).transpose(1, 2).contiguous().requires_grad_(True)
               for a, f in ((q, s), (k, s), (v, 1)))
    g_h = g.reshape(B, T, H, d).transpose(1, 2).contiguous()
    sdpa_fwd = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
    sdpa_both = lambda: torch.autograd.grad(sdpa_fwd(), (q, k, v), g_h)
    bound_ms, bound_by = attention_bwd_bound(B, T, H, d)
    split = kernel_us(lambda: ops.attention_bwd(qkv, g, H, out, lse), BWD_KERNELS)
    rec = {
        "shape": [B, T, H, d],
        "max_abs_err": float(err.max()),
        "ms": time_ms(lambda: ops.attention_bwd(qkv, g, H, out, lse)),
        "dq_us": split.get("attention_bwd_dq_kernel"),
        "dkv_us": split.get("attention_bwd_dkv_kernel"),
        "plain_ms": time_ms(lambda: ops.attention_bwd_plain(qkv, g, H), iters=3),
        "library_ms": max(time_ms(sdpa_both) - time_ms(sdpa_fwd), 0.0),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(f"attention backward {rec['shape']}: max_abs_err {rec['max_abs_err']:.3e} (bound "
          f"{ATTN_ATOL} + {ATTN_RTOL}*M, max err / M {float((err / scale).max()):.3e}, "
          f"gradient rms {rms(want):.3e}); RMS from fp64 on {n} batch elements: kernel "
          f"{d_kernel:.3e}, plain {d_plain:.3e}; kernel_ms {rec['ms']:.4f}, plain_ms "
          f"{rec['plain_ms']:.4f} (at B={B}), device us per launch (profiler) dq kernel "
          f"{rec['dq_us'] or 'not measured'}, dk/dv kernel {rec['dkv_us'] or 'not measured'}, "
          f"library_ms (SDPA fwd+bwd minus fwd) "
          f"{rec['library_ms']:.4f}, bound_us {1e3 * bound_ms:.2f} ({bound_by}), "
          f"exp_unit_us {1e6 * B * H * T * T / PEAK_EXP:.2f}", flush=True)
    return rec


class PlainAttention(torch.autograd.Function):
    """The kernels' plain versions as one differentiable attention: the plain
    forward, and K2's gradient in fp32 einsums (``attention_bwd_plain``)."""

    @staticmethod
    def forward(ctx, qkv, heads):
        from causaldiffae_torch.ops import attention as ops

        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return ops.attention_plain(qkv, heads)

    @staticmethod
    def backward(ctx, g):
        from causaldiffae_torch.ops import attention as ops

        (qkv,) = ctx.saved_tensors
        return ops.attention_bwd_plain(qkv, g, ctx.heads), None


def training_gradients(cfg, model, diffusion, batch, draws):
    """One step's loss gradients, every parameter, flattened to fp64."""
    from causaldiffae_torch.training.train_step import compute_losses

    cond = {k: v for k, v in batch.items() if k != "image"}
    terms = compute_losses(cfg, model, diffusion, batch["image"], cond, draws["t"], 0.5,
                           noise=draws["noise"], rep_noise=draws["rep_noise"],
                           keep=draws["keep"])
    params = [p for p in model.parameters()]
    grads = torch.autograd.grad(terms["loss"].mean(), params, allow_unused=True)
    return torch.cat([(torch.zeros_like(p) if gr is None else gr).double().reshape(-1)
                      for p, gr in zip(params, grads)])


@contextlib.contextmanager
def route_attention(fn):
    """Send the UNet's attention blocks through ``fn(qkv, heads)`` meanwhile."""
    import causaldiffae_torch.models.attention as attn

    saved = attn.fused_qkv_attention, attn.fused_qkv_attention_t
    attn.fused_qkv_attention = attn.fused_qkv_attention_t = fn
    try:
        yield
    finally:
        attn.fused_qkv_attention, attn.fused_qkv_attention_t = saved


@torch.no_grad()
def fill_weights_(model, seed):
    """Every weight ~ N(0, STD^2) (norm scales ~ 1), then each attention qkv
    projection ~ N(0, SCORE_STD / fan_in).

    A fresh init zeroes the attention output projections, so every weight is
    filled. The qkv projection's input is group-normed (variance ~1), so q
    and k get variance SCORE_STD and the scores q.k/sqrt(d) a std of about
    SCORE_STD: a softmax far from uniform, in which a wrong q.k^T shows.
    """
    from causaldiffae_torch.models.attention import AttentionBlock
    from causaldiffae_torch.utils.weights import fill_normal_

    gen = torch.Generator().manual_seed(seed)
    fill_normal_(model, gen, std=STD)
    for blk in model.modules():
        if isinstance(blk, AttentionBlock):
            w = blk.qkv.weight
            draw = torch.randn(w.shape, generator=gen) * (SCORE_STD / w.shape[1]) ** 0.5
            w.copy_(draw.to(w.device, w.dtype))


def rms(a):
    return float(a.float().pow(2).mean().sqrt())


def reset_counts(ops):
    ops.attention_fwd.launches = ops.attention_fwd.lse_launches = 0
    ops.attention_bwd.launches = 0


def counts(ops):
    """(forward, forward writing lse, backward) launches since the last reset."""
    return (ops.attention_fwd.launches, ops.attention_fwd.lse_launches,
            ops.attention_bwd.launches)


def gradient_check(cfg, ops, gen, seed):
    """One step's gradient at batch GRAD_BATCH with the kernels, with their
    plain versions and with fp64 attention, on the same random weights,
    batch and draws: the kernels' may stand at most 1.5x as far from the
    fp64 one (RMS over all parameters) as the plain versions'. One gradient
    launches each kernel once per attention block, every forward writing lse."""
    from causaldiffae_torch.config import create_diffusion, create_model
    from causaldiffae_torch.data import synthetic_dataset
    from causaldiffae_torch.training.loop import to_device

    diffusion = create_diffusion(cfg)
    model = create_model(cfg, device="cuda").train()
    fill_weights_(model, seed)
    B, s = GRAD_BATCH, cfg.image_size
    batch = to_device(synthetic_dataset(cfg.dataset, B, seed=SEED, image_size=s), "cuda")
    draws = {"t": torch.randint(0, diffusion.num_timesteps, (B,), generator=gen, device="cuda"),
             "noise": torch.randn(B, s, s, cfg.in_channels, generator=gen, device="cuda"),
             "rep_noise": torch.randn(B, cfg.rep_dim, generator=gen, device="cuda"),
             "keep": torch.tensor([1.0, 0.0] * (B // 2), device="cuda")}
    before = counts(ops)
    g_kernel = training_gradients(cfg, model, diffusion, batch, draws)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(counts(ops), before))
    n = ATTN_PER_CALL[cfg.name]
    if launched != (n, n, n):
        raise AssertionError(f"one full-width {cfg.name} gradient launched {launched} (forward, "
                             f"forward with lse, backward) attention kernels, expected {n} each")
    with route_attention(PlainAttention.apply):
        g_plain = training_gradients(cfg, model, diffusion, batch, draws)
    with route_attention(lambda qkv, heads: exact_attention(ops, qkv, heads)[0].to(qkv.dtype)):
        g_exact = training_gradients(cfg, model, diffusion, batch, draws)
    d_k, d_p = rms(g_kernel - g_exact), rms(g_plain - g_exact)
    print(f"{cfg.name}: full-width gradient at B={B}, {g_kernel.numel()} parameters: rms "
          f"{rms(g_exact):.4e}; rms distance from the gradient with fp64 attention: kernels "
          f"{d_k:.4e}, plain {d_p:.4e} (ratio {d_k / d_p:.3f}, limit 1.5); kernels vs plain "
          f"{rms(g_kernel - g_plain):.4e}; launches {launched}", flush=True)
    if not bool(torch.isfinite(g_kernel).all()) or d_k > 1.5 * d_p:
        raise AssertionError("the kernels' full-width gradient is not finite or stands farther "
                             "from the fp64-attention gradient than the plain version's allows")
    del model, g_kernel, g_plain, g_exact
    torch.cuda.empty_cache()


def check_records(name, records, steps):
    """The train loop's records of ``steps``: finite losses and grad norms, none skipped."""
    if [r["step"] for r in records] != list(steps):
        raise AssertionError(f"{name}: records of steps {[r['step'] for r in records]}, "
                             f"expected {list(steps)}")
    for r in records:
        if not all(math.isfinite(r[k]) for k in ("loss", "mse", "kld_rep", "grad_norm")) \
                or r["step_skipped"] != 0.0:
            raise AssertionError(f"{name} train step {r['step']}: non-finite loss or grad "
                                 "norm, or skipped")


class SyncedStamps:
    """A batch iterator that syncs the card and stamps the host clock at each
    request. The loop asks for batch k+1 right after it dispatches step k,
    so consecutive stamps bracket one step, its device work included."""

    def __init__(self, data):
        self.data, self.stamps = data, []

    def __iter__(self):
        return self

    def __next__(self):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        return next(self.data)


def train_phase(cfg, ops, gen):
    """Phase 6: the gradient check at batch 16, then the train CLI's loop at
    the preset's batch; returns the kernels' launch counts of the loop."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.data import synthetic_iterator
    from causaldiffae_torch.serve import build_model
    from causaldiffae_torch.training import run_training

    gradient_check(cfg, ops, gen, SEED + 2)
    # the train CLI's code path (train.main builds the same model and loop)
    model = build_model(cfg, "", SEED, "cuda")
    fill_weights_(model, SEED + 3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    data = SyncedStamps(synthetic_iterator(cfg.dataset, cfg.batch_size, seed=SEED,
                                           image_size=cfg.image_size))
    reset_counts(ops)  # the main path's count
    torch.cuda.reset_peak_memory_stats()
    state, records = run_training(cfg, model, create_diffusion(cfg), data,
                                  total_steps=TRAIN_STEPS, log_interval=1, device="cuda")
    fwd, lse_launches, bwd = counts(ops)
    launches = {"attention_fwd": fwd, "attention_bwd": bwd}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_records(cfg.name, records, range(1, TRAIN_STEPS + 1))
    if launches != {k: 8 * TRAIN_STEPS for k in launches}:
        raise AssertionError(f"{launches} attention launches in {TRAIN_STEPS} steps, expected "
                             f"8 of each per step")
    if lse_launches != launches["attention_fwd"]:
        raise AssertionError(f"{lse_launches} of {launches['attention_fwd']} training forward "
                             "launches wrote lse, expected all")
    params = dict(model.named_parameters())
    # a parameter whose gradient is exactly 0 stays (the root variable's SCM
    # input is masked to zero, so its MLP's first weight never gets one)
    zero_grad = [n for n, p in params.items() if not bool(p.grad.any())]
    still = [n for n, p in params.items()
             if torch.equal(p.detach(), before[n]) and n not in zero_grad]
    if still or len(zero_grad) > 2:
        raise AssertionError(f"parameters that did not move: {still}; with a zero gradient: "
                             f"{zero_grad}")
    ema = state.ema[sorted(state.ema)[0]]
    flat = lambda d: torch.cat([d[n].detach().double().reshape(-1) for n in params])
    p_now, p_before, e_now = flat(params), flat(before), flat(ema)
    if not (rms(e_now - p_now) < rms(p_before - p_now) and rms(e_now - p_before) > 0):
        raise AssertionError("the EMA did not move toward the params")
    if all(torch.equal(b, stats[n]) for n, b in model.named_buffers() if n in stats):
        raise AssertionError("the BatchNorm running statistics did not change")
    # stamps[k] - stamps[k-1] is step k between device syncs; steps 3 on are steady
    step_ms = [1e3 * (b - a) for a, b in zip(data.stamps, data.stamps[1:])]
    steady = step_ms[2:]
    step_s = sum(steady) / len(steady) / 1e3
    print(f"train loop, batch {cfg.batch_size}, {TRAIN_STEPS} steps (host clock between device "
          f"syncs, one per step; metrics read back one step late): loss "
          f"{[round(r['loss'], 4) for r in records]}; step ms {[round(t, 2) for t in step_ms]}; "
          f"steady step {1e3 * step_s:.2f} ms over steps 3-{TRAIN_STEPS} "
          f"({cfg.batch_size / step_s:.1f} samples/s); launches {launches} "
          f"({lse_launches} forward launches wrote lse); peak memory {peak_gb:.3f} GB; "
          f"zero-gradient parameters {zero_grad}; EMA rms from params {rms(e_now - p_now):.3e} < "
          f"initial {rms(p_before - p_now):.3e}", flush=True)
    return launches


def cli_phase(name, ops, gen, work, *, steps, save_interval, sampler, sample_steps,
              intervene_var):
    """Phases 7 and 8 on preset ``name`` at full width: the gradient check,
    then the train CLI's ``main`` to step ``steps[0]`` and again to
    ``steps[1]`` (it must resume), then the serve CLI's ``main`` from the
    checkpoint; the files go under ``work``, which the caller removes.
    Returns the kernels' launch counts by path and the checkpoint directory."""
    from causaldiffae_torch import serve, train
    from causaldiffae_torch.config import get_config
    from causaldiffae_torch.training import CheckpointManager

    cfg = get_config(name)
    n = ATTN_PER_CALL[name]
    gradient_check(cfg, ops, gen, SEED + 4)
    ckpt, logdir = os.path.join(work, "ckpt"), os.path.join(work, "log")
    args = ["--preset", name, "--synthetic", "--save_interval", str(save_interval),
            "--log_interval", "1", "--ckpt_dir", ckpt, "--logdir", logdir]
    reset_counts(ops)  # the training path's count
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, first = train.main(args + ["--total_steps", str(steps[0])])
    t_first = time.perf_counter() - t0
    fwd, lse, bwd = counts(ops)
    if (state.step, fwd, lse, bwd) != (steps[0], n * steps[0], n * steps[0], n * steps[0]):
        raise AssertionError(f"{name}: train CLI to step {steps[0]} ended at step "
                             f"{state.step} with (forward, with lse, backward) launches "
                             f"{(fwd, lse, bwd)}, expected {n} each per step")
    state, second = train.main(args + ["--total_steps", str(steps[1])])
    train_counts = counts(ops)
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    more = steps[1] - steps[0]
    if (state.step, train_counts) != (steps[1], (fwd + n * more, lse + n * more,
                                                 bwd + n * more)):
        raise AssertionError(f"{name}: the resumed train CLI ended at step {state.step} with "
                             f"launches {train_counts}, expected {n} of each per step")
    check_records(name, first + second, range(1, steps[1] + 1))  # resumed at steps[0]
    saved = CheckpointManager(ckpt).all_steps()
    on_interval = [k for k in range(save_interval, steps[1] + 1, save_interval)]
    if saved != sorted(set(on_interval + list(steps)))[-3:]:
        raise AssertionError(f"{name}: checkpoints at steps {saved}")
    with open(os.path.join(logdir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    if [int(float(r["step"])) for r in rows] != list(range(1, steps[1] + 1)):
        raise AssertionError(f"{name}: progress.csv rows of steps {[r['step'] for r in rows]}")
    recs = first + second
    print(f"{name}: train CLI, batch {cfg.batch_size}, steps 1-{steps[0]}, then resumed at "
          f"{steps[0]} to {steps[1]}; checkpoints {saved}; loss "
          f"{[round(r['loss'], 4) for r in recs]}; grad norm "
          f"{[round(r['grad_norm'], 3) for r in recs]}; step_time_s (stamped at dispatch, "
          f"saves included) {[round(r['step_time_s'], 4) for r in recs]}; samples_per_sec "
          f"{round(first[-1]['samples_per_sec'], 1)}, {round(second[-1]['samples_per_sec'], 1)}; "
          f"first main() {t_first:.1f} s with the synthetic pool; launches (forward, with lse, "
          f"backward) {train_counts}; peak memory {peak_train:.3f} GB", flush=True)

    out = os.path.join(work, "answers.npz")
    serve_args = ["--preset", name, "--ckpt_dir", ckpt, "--synthetic", "16", "--batch", "16",
                  "--value", "1.0", "--intervene_var", str(intervene_var), "--sampler",
                  sampler, "--out", out, "--seed", str(SEED)]
    if sample_steps:
        serve_args += ["--sample_steps", str(sample_steps)]
    reset_counts(ops)  # the serving path's count
    torch.cuda.reset_peak_memory_stats()
    records = serve.main(serve_args)
    fwd, lse, _ = counts(ops)
    peak_serve = torch.cuda.max_memory_allocated() / 1e9
    calls = sum(r["unet_calls"] for r in records)
    with np.load(out) as z:
        samples = z["samples"]
    s = cfg.image_size
    if not (samples.shape == (16, s, s, cfg.in_channels) and np.isfinite(samples).all()
            and float(np.abs(samples).max()) <= 1.0 + 1e-6):
        raise AssertionError(f"{name}: answers not finite, of shape {samples.shape} or "
                             "outside [-1, 1]")
    if fwd != n * calls or lse:
        raise AssertionError(f"{name}: {fwd} forward launches ({lse} with lse) for {calls} "
                             f"UNet calls, expected {n} per call and none with lse")
    lat = records[0]["latency_s"]
    print(f"{name}: serve CLI from step {steps[1]} (EMA weights), 16 requests, {sampler}: "
          f"{calls} UNet calls, latency {lat:.3f} s ({1e3 * lat / calls:.2f} ms per UNet "
          f"call, {16 / lat:.2f} images/s, first batch of the process), {fwd} forward "
          f"launches, none with lse; peak memory {peak_serve:.3f} GB", flush=True)
    return {"training": train_counts, "serving": fwd}, ckpt


def fresh_runs(work, tag, module, argv, setup="", n=2):
    """``n`` runs of ``python -m causaldiffae_torch.<module>``'s ``main(argv +
    [dir])``, each in a fresh process, all started together; ``setup`` runs
    first in each. Returns their directories (``<work>/<tag>-<i>``)."""
    dirs = [os.path.join(work, f"{tag}-{i}") for i in range(n)]
    procs = []
    try:
        for d in dirs:
            code = (f"{setup}from causaldiffae_torch import {module}\n"
                    f"{module}.main({argv + [d]!r})\n")
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                          text=True))
        for p in procs:
            _, err = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"{module} in a fresh process exited {p.returncode}:\n"
                                     f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return dirs


def state_spread(a, b):
    """``differences`` of two states, summed up: (tensors compared, tensors
    that differ, the largest |a - b| of each top-level part)."""
    from causaldiffae_torch.utils.determinism import differences, tensors

    diff = differences(a, b)
    worst = {}
    for path, v in diff.items():
        part = path.split("/")[1]
        worst[part] = max(worst.get(part, 0.0), v)
    return len(dict(tensors(a))), len(diff), worst


def probe_states(out_dir):
    """The probes the ``classifier_train`` CLI saved in ``out_dir``, by file."""
    import pickle

    states = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            saved = pickle.load(f)
        states[name] = {k: torch.from_numpy(v) for k, v in saved["state_dict"].items()}
    return states


def repeatability_phase(work):
    """Phase 8b: the same work twice from the same seed and weights, bit for
    bit. Raises on a difference in any run the port's entry points pin;
    reports the runs with the pin undone, which show the source."""
    from causaldiffae_torch import serve, train
    from causaldiffae_torch.training import CheckpointManager

    load = lambda d: CheckpointManager(d).load()
    found = {}
    # 1. the train CLI twice in this process, 2 steps from the seed's weights
    here = [os.path.join(work, f"repeat-{i}") for i in range(2)]
    for d in here:
        train.main(REPEAT_TRAIN + ["--ckpt_dir", d])
    found["train CLI, in this process"] = state_spread(load(here[0]), load(here[1]))
    # 2. in two fresh processes each (TF32 off, as here)
    fresh = fresh_runs(work, "repeat-fresh", "train", REPEAT_TRAIN + ["--ckpt_dir"], TF32_OFF)
    found["train CLI, fresh processes"] = state_spread(load(fresh[0]), load(fresh[1]))
    # 3. one DDIM-250 do() batch of 16 twice from the same checkpoint
    answers = []
    for i in range(2):
        out = os.path.join(work, f"repeat-ddim-{i}.npz")
        serve.main(["--ckpt_dir", here[0], "--synthetic", "16", "--batch", "16", "--value", "1.0",
                    "--out", out, "--seed", str(SEED)])
        with np.load(out) as z:
            answers.append({"samples": torch.from_numpy(z["samples"])})
    found["DDIM-250 do() batch"] = state_spread(*answers)
    # 4. the evaluation's probes (fp32 convolutions), as the CLI runs them
    probes = fresh_runs(work, "repeat-probes", "classifier_train", PROBE_ARGS, TF32_OFF)
    found["probes, fresh processes"] = state_spread(*map(probe_states, probes))
    # 5. the train CLI and the probes with the pin undone (the setting before it)
    fresh = fresh_runs(work, "repeat-unpinned", "train", REPEAT_TRAIN + ["--ckpt_dir"],
                       TF32_OFF + UNPIN)
    unpinned = {"train CLI": state_spread(load(fresh[0]), load(fresh[1]))}
    probes = fresh_runs(work, "repeat-probes-unpinned", "classifier_train", PROBE_ARGS,
                        TF32_OFF + UNPIN)
    unpinned["probes"] = state_spread(*map(probe_states, probes))
    for pinned, runs in ((True, found), (False, unpinned)):
        for what, (n, k, worst) in runs.items():
            print(f"repeatability, {what}{'' if pinned else ', cuDNN unpinned'}: {k} of {n} "
                  f"tensors differ" + (f", max |a - b| by part {worst}" if k else " (bit-equal)"),
                  flush=True)
    if unpinned["probes"][1] and not unpinned["train CLI"][1]:
        print("repeatability: the source is cuDNN's nondeterministic fp32 convolution backward "
              "in the probes, which the pin replaces; the train step (its bf16 convolutions, "
              "nn.Embedding) gives the same bits either way", flush=True)
    for name in os.listdir(work):  # ~0.6 GB a checkpoint
        path = os.path.join(work, name)
        if name.startswith("repeat-"):
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    differ = [what for what, (_, k, _) in found.items() if k]
    if differ:
        raise AssertionError(f"two runs from the same seed and weights are not bit-equal: {differ}")


@contextlib.contextmanager
def count_unet_calls():
    """Counts ``CausalUNet.denoise`` calls meanwhile (every chain step, every
    VLB term); yields a one-element list."""
    from causaldiffae_torch.models.unet import CausalUNet

    original, calls = CausalUNet.denoise, [0]

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return original(self, *args, **kwargs)

    CausalUNet.denoise = counted
    try:
        yield calls
    finally:
        CausalUNet.denoise = original


def png_size(path):
    """(width, height) from a PNG's signature and IHDR; raises on anything else."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG file")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def check_launches(what, ops, calls, per_call):
    """The forward kernel ran ``per_call`` times per UNet call, none writing
    lse, and the backward never; returns the forward launches."""
    fwd, lse, bwd = counts(ops)
    if (fwd, lse, bwd) != (per_call * calls, 0, 0):
        raise AssertionError(f"{what}: (forward, with lse, backward) launches {(fwd, lse, bwd)} "
                             f"for {calls} UNet calls, expected {per_call} forward per call")
    return fwd


def check_samples(what, path, shape, key="samples"):
    """The images under ``key`` in ``path``: of ``shape``, finite, in [-1, 1]."""
    with np.load(path) as z:
        samples = z[key]
    if not (samples.shape == shape and np.isfinite(samples).all()
            and float(np.abs(samples).max()) <= 1.0 + 1e-6):
        raise AssertionError(f"{what}: samples not finite, outside [-1, 1] or of shape "
                             f"{samples.shape}, expected {shape}")


def evaluation_phase(name, ops, ckpt, out, *, num_samples, sampler, sample_steps,
                     compute_fid):
    """The ``counterfactual_test`` CLI on the checkpoint in ``ckpt`` with
    probes trained in-process, then ``rescore_counterfactuals`` with the same
    probes; returns the forward kernel's launches in the evaluation."""
    from causaldiffae_torch import counterfactual_test, rescore_counterfactuals
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.interventions import VAR_NAMES
    from causaldiffae_torch.serve import unet_calls_per_chain

    cfg = get_config(name)
    names = VAR_NAMES[cfg.dataset]
    bs = 16
    args = ["--ckpt_dir", ckpt, "--synthetic", "--num_samples", str(num_samples), "--batch_size",
            str(bs), "--clf_epochs", str(CLF_EPOCHS), "--out_dir", out, "--seed", str(SEED)]
    if sampler:
        args += ["--sampler", sampler, "--sample_steps", str(sample_steps)]
    if compute_fid:
        args += ["--compute_fid"]
    reset_counts(ops)  # the evaluation path's count
    t0 = time.perf_counter()
    with count_unet_calls() as calls:
        result = counterfactual_test.main(args)
    seconds = time.perf_counter() - t0
    chain = unet_calls_per_chain(cfg, create_diffusion(cfg, eval_mode=True), sampler or "ddim",
                                 sample_steps)
    n_batches = num_samples // bs
    if calls[0] != chain * (1 + len(names) * n_batches):
        raise AssertionError(f"{name}: {calls[0]} UNet calls, expected {chain} per chain for the "
                             f"reconstruction and {len(names)} x {n_batches} do() batches")
    fwd = check_launches(f"{name} evaluation", ops, calls[0], ATTN_PER_CALL[name])
    keys = {f"{k}_{v}" for v in names for k in ("mae", "clf_val_mse")} | (
        {"fid"} if compute_fid else set())
    if set(result) != keys or not all(math.isfinite(v) for v in result.values()) \
            or result.get("fid", 0.0) < 0:
        raise AssertionError(f"{name}: evaluation result {result}, expected finite {sorted(keys)}"
                             " and fid >= 0")
    s = cfg.image_size
    for v in names:
        check_samples(f"{name} do({v})", os.path.join(out, f"samples_do_{v}.npz"),
                      (num_samples, s, s, cfg.in_channels))
        rows = -(-min(num_samples, 64) // 8)
        if png_size(os.path.join(out, f"grid_do_{v}.png")) != (8 * s, rows * s):
            raise AssertionError(f"{name}: grid_do_{v}.png has the wrong size")
    if png_size(os.path.join(out, "reconstructions.png")) != (8 * s, 2 * s):
        raise AssertionError(f"{name}: reconstructions.png has the wrong size")
    t1 = time.perf_counter()
    (rescored,) = rescore_counterfactuals.main(
        ["--preset", name, "--classifier_dir", out, "--runs", out, "--num_samples",
         str(num_samples), "--batch_size", str(bs), "--seed", str(SEED)])
    rescore_s = time.perf_counter() - t1
    worst = max(abs(rescored[f"mae_{v}"] - result[f"mae_{v}"]) / abs(result[f"mae_{v}"])
                for v in names)
    if worst > RESCORE_RTOL:
        raise AssertionError(f"{name}: the rescore {rescored} does not reproduce {result}")
    print(f"{name}: counterfactual_test {seconds:.2f} s ({CLF_EPOCHS}-epoch probes, "
          f"{calls[0]} UNet calls, {1e3 * seconds / calls[0]:.2f} ms per UNet call including "
          f"the probes, pools and files), {fwd} forward launches, none with lse; "
          f"rescore {rescore_s:.3f} s, largest relative MAE difference {worst:.3e} "
          f"(limit {RESCORE_RTOL}); result {json.dumps(result)}", flush=True)
    return fwd


def vb_route_check(cfg, ops, gen):
    """``vb_terms_bpd`` at six timesteps (0, 1, T/100, T/10, T/2, T-1) on
    the same x_t through the kernel,
    the plain attention and fp64 attention (random weights with sharp
    softmaxes): the kernel's terms no farther from fp64's (RMS) than 1.5x
    the plain route's."""
    from causaldiffae_torch.config import create_diffusion, create_model

    diffusion = create_diffusion(cfg)
    T = diffusion.num_timesteps
    steps = sorted({0, 1, T // 100, T // 10, T // 2, T - 1})
    model = create_model(cfg, device="cuda")
    fill_weights_(model, SEED + 5)
    B, s = 8, cfg.image_size
    x = torch.rand(B, s, s, cfg.in_channels, generator=gen, device="cuda")
    y = torch.arange(B, device="cuda") % 10
    z = torch.randn(B, cfg.rep_dim, generator=gen, device="cuda")
    noise = torch.randn(len(steps), B, s, s, cfg.in_channels, generator=gen, device="cuda")
    model_fn = lambda xx, tt: model.denoise(xx, tt, y=y, z=z)

    def terms():
        out = []
        for t_int, eps in zip(steps, noise):
            t = torch.full((B,), t_int, dtype=torch.long, device="cuda")
            x_t = diffusion.q_sample(x, t, eps)
            out.append(diffusion.vb_terms_bpd(model_fn, x, x_t, t)["output"].double())
        return torch.stack(out)

    with torch.inference_mode():
        vb_k = terms()
        with route_attention(ops.attention_plain):
            vb_p = terms()
        with route_attention(lambda qkv, heads: exact_attention(ops, qkv, heads)[0].to(qkv.dtype)):
            vb_x = terms()
    d_k, d_p = rms(vb_k - vb_x), rms(vb_p - vb_x)
    print(f"vb_terms_bpd at t {steps}, batch {B}: rms {rms(vb_x):.4e} bits/dim; rms "
          f"distance from fp64 attention: kernel {d_k:.4e}, plain {d_p:.4e} (ratio "
          f"{d_k / d_p:.3f}, limit 1.5)", flush=True)
    if not bool(torch.isfinite(vb_k).all()) or d_k > 1.5 * d_p:
        raise AssertionError("the VLB terms through the kernel are not finite or stand farther "
                             "from fp64 attention's than the plain route's allows")


def nll_and_sampling_phase(ops, gen, ckpt, work):
    """Phase 10: the ``nll`` CLI on one batch of 8, the VLB route check, and
    16 prior samples from the ``sample`` CLI; returns the launches by path."""
    from causaldiffae_torch import nll, sample
    from causaldiffae_torch.config import get_config

    cfg = get_config("morphomnist_causaldae")
    reset_counts(ops)  # the NLL path's count
    t0 = time.perf_counter()
    with count_unet_calls() as calls:
        total = nll.main(["--ckpt_dir", ckpt, "--num_samples", "8", "--batch_size", "8",
                          "--out_dir", os.path.join(work, "nll"), "--seed", str(SEED)])
    seconds = time.perf_counter() - t0
    if calls[0] != cfg.diffusion_steps or not (math.isfinite(total) and total > 0):
        raise AssertionError(f"nll: total_bpd {total} after {calls[0]} UNet calls, expected a "
                             f"finite positive bpd after {cfg.diffusion_steps}")
    nll_fwd = check_launches("nll", ops, calls[0], ATTN_PER_CALL[cfg.name])
    print(f"nll: one batch of 8, {calls[0]} UNet calls in {seconds:.2f} s "
          f"({1e3 * seconds / calls[0]:.2f} ms per UNet call, the encoder and files included), "
          f"total_bpd {total:.4f}, "
          f"{nll_fwd} forward launches, none with lse", flush=True)
    vb_route_check(cfg, ops, gen)

    reset_counts(ops)  # the prior sampling path's count
    t0 = time.perf_counter()
    with count_unet_calls() as calls:
        path = sample.main(["--ckpt_dir", ckpt, "--num_samples", "16", "--batch_size", "16",
                            "--sampler", "dpm++", "--sample_steps", "25", "--out_dir",
                            os.path.join(work, "samples"), "--seed", str(SEED)])
    seconds = time.perf_counter() - t0
    check_samples("sample", path, (16, 28, 28, 1), key="arr_0")
    sample_fwd = check_launches("sample", ops, calls[0], ATTN_PER_CALL[cfg.name])
    print(f"sample: 16 prior samples, DPM++-25, {calls[0]} UNet calls in {seconds:.3f} s, "
          f"{sample_fwd} forward launches, none with lse", flush=True)
    return {"nll": nll_fwd, "prior_sampling": sample_fwd}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card")
    sys.path.insert(0, REPO)
    from causaldiffae_torch import serve
    from causaldiffae_torch.config import create_model, get_config
    from causaldiffae_torch.ops import _build
    from causaldiffae_torch.ops import attention as ops

    t_start = time.perf_counter()
    phase = PhaseClock()
    phase("1. environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card_line = smi.splitlines()[0]
    print(f"card: {card_line}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: the fp32 plain versions run in full fp32")

    phase("2. build")
    ptxas = build_phase(ops, _build)

    phase("3. forward kernel against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn_recs = [check_attention(ops, *shape, gen) for shape in ATTN_SHAPES]

    phase("3b. backward kernel against its plain version")
    bwd_recs = [check_backward(ops, *shape, gen) for shape in BWD_SHAPES]
    torch.cuda.empty_cache()

    phase("4. full-width denoise: kernel vs plain attention")
    cfg = get_config("morphomnist_causaldae")
    model = create_model(cfg, device="cuda")
    fill_weights_(model, SEED)
    B = 16
    x = torch.randn(B, 28, 28, 1, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    y = torch.arange(B, device="cuda") % 10
    z = torch.randn(B, cfg.rep_dim, generator=gen, device="cuda")
    seen = []  # the qkv each attention block hands the kernel

    def capture(qkv, heads):
        seen.append((qkv, heads))
        return ops.attention_fwd(qkv, heads)

    with torch.inference_mode():
        denoise = lambda: model.denoise(x, t, y=y, z=z)
        n0 = ops.attention_fwd.launches
        with route_attention(capture):
            eps_k = denoise()
        torch.cuda.synchronize()
        if ops.attention_fwd.launches - n0 != 8:
            raise AssertionError(f"{ops.attention_fwd.launches - n0} kernel launches in one "
                                 "full-width denoise, expected 8")
        for i, (qkv, heads) in enumerate(seen):
            err, rel, want_rms = check_against_plain(ops, qkv, heads, f"attention block {i}")
            score_std, eff = softmax_sharpness(qkv, heads)
            print(f"attention block {i}: qkv {tuple(qkv.shape)}, score std {score_std:.2f}, "
                  f"mean effective keys {eff:.1f} of {qkv.shape[1]}, kernel vs plain max abs "
                  f"err {err:.3e}, max err / sum p|v| {rel:.3e} (output rms {want_rms:.3e}); "
                  f"against fp64, max err / sum p|v|: kernel "
                  f"{exact_error(ops, qkv, heads, ops.attention_fwd(qkv, heads)):.3e}, plain "
                  f"{exact_error(ops, qkv, heads, ops.attention_plain(qkv, heads)):.3e}")
            if eff > qkv.shape[1] / 2:
                raise AssertionError(f"attention block {i}: softmax near uniform, the check "
                                     "would not see the scores")
        del seen[:]
        with route_attention(ops.attention_plain):
            eps_p = denoise()
        with route_attention(lambda qkv, heads: exact_attention(ops, qkv, heads)[0].to(qkv.dtype)):
            eps_x = denoise()
        # in turns (kernel, plain, plain, kernel): the host's clock drifts
        turns = {"kernel": [], "plain": []}
        for side in ("kernel", "plain", "plain", "kernel"):
            with route_attention(ops.attention_plain) if side == "plain" \
                    else contextlib.nullcontext():
                turns[side].append(wall_ms(denoise))
    diff = eps_k - eps_p
    d_k, d_p = rms(eps_k - eps_x), rms(eps_p - eps_x)
    print(f"eps: shape {tuple(eps_k.shape)}, rms {rms(eps_p):.4f}, max|eps| "
          f"{float(eps_p.abs().max()):.4f}; kernel vs plain rms {rms(diff):.3e}, "
          f"max {float(diff.abs().max()):.3e}; rms distance from eps with fp64 attention: "
          f"kernel {d_k:.3e}, plain {d_p:.3e}")
    print(f"denoise at B={B}, host clock, ms per call in turns: "
          f"with the kernel {turns['kernel']}, with the plain attention {turns['plain']}")
    if not (torch.isfinite(eps_k).all() and eps_k.shape == (B, 28, 28, 1)):
        raise AssertionError("denoise output is not finite or has the wrong shape")
    # bf16 bound: each attention output rounds differently (see ATTN_RTOL) and
    # the bf16 network carries that to eps, so the kernel's eps may stand no
    # more than 1.5x as far from eps with fp64 attention as the plain version's
    if d_k > 1.5 * d_p:
        raise AssertionError("full-width eps with the kernel is farther from eps with exact "
                             "attention than the plain version's allows")

    phase("5. serving: counterfactual requests on morphomnist_causaldae")
    del model, denoise, eps_k, eps_p, eps_x, diff
    torch.cuda.empty_cache()
    model = serve.build_model(cfg, "", SEED, "cuda")
    fill_weights_(model, SEED + 1)
    requests = serve.synthetic_requests(cfg, 32, SEED)
    runs = [("ddim", None, requests), ("dpm++", 25, {k: v[:16] for k, v in requests.items()})]
    reset_counts(ops)  # the main path's count
    torch.cuda.reset_peak_memory_stats()
    unet_calls = 0
    for sampler, steps, req in runs:
        for rec in serve.serve(cfg, model, req, intervene_var=0, value=1.0, sampler=sampler,
                               sample_steps=steps, batch=16, seed=SEED, device="cuda"):
            samples = rec.pop("samples")
            unet_calls += rec["unet_calls"]
            if not (rec["finite"] and samples.shape == (16, 28, 28, 1)
                    and float(abs(samples).max()) <= 1.0 + 1e-6):
                raise AssertionError(f"{sampler} batch {rec['batch']}: outputs not finite, "
                                     "not of shape (16, 28, 28, 1) or outside [-1, 1]")
            print(json.dumps(rec), flush=True)
    launches = {"attention_fwd": ops.attention_fwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"UNet calls {unet_calls}, attention launches {launches['attention_fwd']}, "
          f"peak memory {peak_gb:.3f} GB")
    if launches["attention_fwd"] != 8 * unet_calls:
        raise AssertionError(f"attention launches {launches['attention_fwd']} != "
                             f"8 x {unet_calls} UNet calls")
    if ops.attention_fwd.lse_launches:
        raise AssertionError(f"{ops.attention_fwd.lse_launches} serving launches wrote lse")

    phase("6. training: morphomnist_causaldae at full width")
    del model
    torch.cuda.empty_cache()
    train_launches = train_phase(cfg, ops, gen)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(REPO, "build"))
    try:  # checkpoints (2.6 GB each for the circuit) and evaluation files
        phase("7. circuit_causaldae at full width: train, checkpoint, resume, serve")
        circuit, _ = cli_phase("circuit_causaldae", ops, gen, os.path.join(work, "circuit"),
                               steps=(4, 6), save_interval=2, sampler="ddim", sample_steps=None,
                               intervene_var=0)
        shutil.rmtree(os.path.join(work, "circuit"))
        phase("8. pendulum_causaldae at full width: train, checkpoint, resume, serve")
        pendulum, pendulum_ckpt = cli_phase("pendulum_causaldae", ops, gen,
                                            os.path.join(work, "pendulum"), steps=(2, 4),
                                            save_interval=2, sampler="dpm++", sample_steps=25,
                                            intervene_var=2)

        phase("8b. repeatability: train, serve and the probes twice, bit for bit")
        repeatability_phase(work)
        phase("9. morphomnist_causaldae: effectiveness MAE, FID and the rescore")
        from causaldiffae_torch import train

        morpho_ckpt = os.path.join(work, "morpho-ckpt")
        t0 = time.perf_counter()
        train.main(["--preset", "morphomnist_causaldae", "--synthetic", "--total_steps", "2",
                    "--save_interval", "2", "--log_interval", "1", "--ckpt_dir", morpho_ckpt])
        print(f"train CLI: 2 steps and a checkpoint in {time.perf_counter() - t0:.2f} s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        torch.cuda.reset_peak_memory_stats()  # the phase's peak is then the evaluation's
        evaluation = evaluation_phase("morphomnist_causaldae", ops, morpho_ckpt,
                                      os.path.join(work, "morpho-eval"), num_samples=32,
                                      sampler=None, sample_steps=None, compute_fid=True)
        phase("10. morphomnist_causaldae: the NLL sweep and prior samples")
        nll_paths = nll_and_sampling_phase(ops, gen, morpho_ckpt, work)
        phase("11. pendulum_causaldae: effectiveness MAE on phase 8's checkpoint")
        evaluation_pendulum = evaluation_phase(
            "pendulum_causaldae", ops, pendulum_ckpt, os.path.join(work, "pendulum-eval"),
            num_samples=16, sampler="dpm++", sample_steps=25, compute_fid=False)
        phase()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def record(name, replaces, recs, launches_by_path):
        main_rec = recs[0]
        return {
            "name": name, "route": "cuda", "source": f"causaldiffae_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **{k: main_rec[k] for k in ("ms", "ms_with_lse", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "dq_us", "dkv_us", "shape")
               if k in main_rec},
            "other_shapes": recs[1:],
            "ptxas": ptxas[name],
        }

    kernels = [
        record("attention_fwd", "causaldiffae_tpu/ops/attention_pallas.py:116 (_attn_kernel) "
               "and :280 (_attn_kernel_t)", attn_recs,
               {"serving": launches["attention_fwd"], "training": train_launches["attention_fwd"],
                "serving_circuit": circuit["serving"], "training_circuit": circuit["training"][0],
                "serving_pendulum": pendulum["serving"],
                "training_pendulum": pendulum["training"][0],
                "evaluation": evaluation, **nll_paths,
                "evaluation_pendulum": evaluation_pendulum}),
        record("attention_bwd", "causaldiffae_tpu/ops/attention_pallas.py:184 "
               "(_attn_bwd_kernel) and :308 (_attn_bwd_kernel_t)", bwd_recs,
               {"training": train_launches["attention_bwd"],
                "training_circuit": circuit["training"][2],
                "training_pendulum": pendulum["training"][2]}),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
