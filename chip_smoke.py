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
3c. the norm kernels (``csrc/norm_act.cu``): built, ptxas's report (raising
   where a forward kernel spills, or a backward one spills more than
   ``NORM_BWD_SPILL`` bytes), then at every shape of the pendulum UNet's 62
   norms at batch 32 and 16 (scale-shift and SiLU; SiLU alone on the fp32
   output norm): the statistics within 1e-5 of the plain ones, the forward
   equal bit for bit to the eager chain's elementwise ops on them, and in
   bf16 equal to the eager chain in at least 99% of elements, in fp32 within
   1e-5; the backward, fed the kernel's statistics, within one ulp (bf16
   outputs) plus 1e-4 of its terms' magnitudes of the plain fp32 formula
   (``tests/_norm_reference.py``, as the card tests), d_weight and d_bias
   equal across two launches; with their times beside the byte bound, the
   eager chain's and ``F.group_norm``'s (the yardstick), and their sums
   weighted by each shape's calls; then one pendulum UNet forward without a
   gradient and one with a backward: 62 norm launches each way. The norm
   launch counters are reset with the attention ones before every main path
   below and read after it: each UNet call launches the forward once per
   ``GroupNorm32`` as it launches the attention forward once per block, and
   each backward the backward alike (forward at least as often under remat);
   the counts by path are the norm kernels' records, and a path that breaks
   that rule fails the run after the last phase;
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
   plain versions (forward and backward) and with fp64 attention, for three
   draws (the kernels' no more than 1.5x as far from the fp64 ones, RMS over
   all parameters and the draws); then 8 steps of the train CLI's loop at the preset's batch
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
9. the effectiveness evaluation of ``morphomnist_causaldae``: on the
   checkpoint of 2 train CLI steps written after phase 6, the
   ``counterfactual_test`` CLI (DDIM-250, 32 samples in batches of 16, two probes trained in-process,
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
   call;
12. ``morphomnist_causaldae`` with the flow prior and dropout
   (``flow_based=True, masking=False, dropout=0.1``) at full width: the
   gradient check of phase 6 at batch 16 (the same dropout masks on every
   route), then 4 steps of the train loop at batch 128 (finite, none
   skipped, 8 forward launches with lse and 8 backward per step, every flow
   parameter moved), and 2 steps with a checkpoint and a resume to step 4,
   bit-equal to the 4 straight steps; step time, samples/s, peak memory;
13a. the train CLI under ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` (NCCL at world size 1, the model in DDP) and the
   plain train CLI, 2 steps each in fresh processes: their checkpoints
   bit-equal;
13b. data parallelism on the one card with two gloo ranks (NCCL takes one
   rank per device): the first train step at the global batch of 128, 64
   rows per rank, against one process at 128 on the same global draws (the
   all-reduced gradient within 1e-2 relative L2 of it, bit-equal on both
   ranks, 8 launches of each kind per rank), 3 more steps timed per rank;
   then the ``counterfactual_test`` CLI on the two ranks (8 samples each
   per variable through DPM++-25, the 2 probes trained by rank 0): the
   same JSON on both, only rank 0 writes, a finite MAE, both ranks' samples
   in the archive (``process_count`` 2). The kernels were built in this
   process (phase 2); each rank loads them;
14. serving artifacts at full width. Four jobs run in processes of their
   own (an AOTInductor compile takes minutes), started after phase 16 so
   that the timed phases 7, 8, 12, 13 and 16 run on a quiet host and card,
   beside phases 8b, 9, 10 and 11, which run after 16: the morphomnist
   DDIM-250 counterfactual at batch 16 with its AOT package, from the train
   CLI's 2-step checkpoint (written after phase 6; phases 9, 10 and 13b read
   it); the same chain without a package and a DPM++-25 one with a symbolic
   batch, from a copy of that checkpoint with every weight filled
   (``fill_weights_``: 2 steps leave the attention output projections and
   the UNet's last layer near their zero init, so the 2-step answers barely
   depend on the attention op's); the pendulum's DPM++-25 one on phase 8's
   checkpoint; and one UNet call of the flagship on the filled weights
   compiled into an AOT package. Every artifact is verified by the CLI.
   Then (a) each graph holds the attention op (8 nodes) and each program,
   the AOT package included, reproduces the direct call within
   max(1e-5, 2e-5 x 250); the one-call package's eps stands no farther from
   the eager call's than ``AOT_CALL_RATIO`` x the plain attention's, 8
   launches and none with lse (on the filled weights a 250-step chain
   carries any bf16 rounding difference far past the atol, so the chain's
   package is held to it on the 2-step weights); (b) ``serve_artifact`` serves 3 batches
   of 16 from the AOT package (``--prewarm``, ``"aot": true``), from the
   portable program (``--no_aot``) and in a fresh process that loads no
   model code, 8 forward launches per UNet call and none with lse each
   time; (c) the same request and draws through each DDIM-250 program and
   through in-process serving on its weights, within that atol; (d) the
   symbolic batch served at 1 and 16; (e) the pendulum artifact, 1 launch
   per UNet call; (f) first-call and steady latency of the three routes
   beside in-process serving. Phase 5 also times the host cost of one
   forward call through the dispatcher op against the ctypes wrapper;
15. one bf16 forward of ``create_sr_model`` at 256 from 64 (batch 4, time
   and peak memory), ``feature_vectors`` on the flagship (as many
   activations as the JAX structure has), the native loader at batch 128
   (its route, batches/s against the numpy iterator, two loaders from one
   seed bit-equal) and ``validate_adjacency`` for 20 steps.

16a. tensor parallelism at full width: two gloo ranks on the card, tp = 2,
   dp = 1, with remat, ``morphomnist_causaldae`` at batch 128 through
   ``run_training`` with ``model_parallel = 2``: step 1 and a checkpoint,
   then a fresh model that resumes from it to step 3. Step 1's gradient,
   gathered from the shards and bit-equal on the two ranks, against one
   process's on the same filled weights and draws: no farther from the
   gradient with fp64 attention than 1.5x the plain attention's, and no
   farther from one process's than 1.5x the plain attention's stands from
   the kernels' (bf16 moves this gradient ~2e-2 under any rounding change);
   in fp32, within 1e-2 of one process's; the step-3 checkpoint (a
   one-process file) against a one-process run's: the same keys and
   shapes, the params within 1e-2.
   Prints the 23 sharded ResBlocks, the kernels' launches per rank per step
   (8 forward with lse, 8 backward), the TP all-reduces per rank per step
   (forward, backward, remat's recompute and the norms apart), peak memory
   and wall time per step per rank;
16b. ``use_remat`` at full width in one process: the flagship's first step
   with and without it, each on a fresh state: the same loss and gradients
   (bit-equal under ``determinism.pin``, or within 1e-2) and each one's
   peak memory; then each one's device time per step, in turns.

The phases run in the order 1-3, 3b, 3c, 4-8, 12, 13a, 13b, 16a, 16b, 8b, 9, 10, 11, 14, 15.
Each phase prints its wall time. Prints the card line and one
``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import csv
import itertools
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
    (64, 784, 4, 32),   # morphomnist training on each of 2 ranks (global batch 128)
    (64, 49, 4, 64),
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
    (64, 784, 4, 32),   # morphomnist training on each of 2 ranks
    (64, 49, 4, 64),
]
BWD_KERNELS = ("attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")
# the attention launches of one UNet call of each preset (forward; the same
# count of backward launches per train step)
ATTN_PER_CALL = {"morphomnist_causaldae": 8, "circuit_causaldae": 15, "pendulum_causaldae": 1}
NORMS_PER_CALL = {"morphomnist_causaldae": 55, "circuit_causaldae": 104, "pendulum_causaldae": 62}
NORM_BY_PATH = {}     # path -> [forward, backward] norm launches, for the kernels' records
NORM_FAULTS = []      # paths whose norm launches broke the rule, raised after the last phase
LSE_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 logsumexp: exp2 and sums in another order
FP64_BATCH = 16         # the fp64 gradient check runs on the first 16 batch elements
TRAIN_STEPS = 8
GRAD_BATCH = 16         # the plain and fp64 routes hold [B, 4, 784, 784] per block
# the gradient check's distance is dominated by a few small tensors (the
# largest share, printed, is the encoder's first conv's), so one draw's
# kernel/plain ratio spreads widely (one read 1.624 on the flow model, on an
# NVIDIA H100 80GB HBM3 at 700 W);
# the check pools the squared distances of three draws
GRAD_DRAWS = 3
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
POOL = 4096           # the synthetic training pool (data.synthetic.POOL)
# phase 12: the flagship with the flow prior (no keep-mask, so the KL's mask is
# the flow's -mean(log_det)) and dropout in every ResBlock
FLOW_DROPOUT = dict(flow_based=True, masking=False, dropout=0.1)
# phase 13b: two ranks against one process differ only in cuDNN's algorithms for
# batches of 64 and 128 and in the order of the sums (the all-reduces, BatchNorm's
# global statistics), which the bf16 torso carries to the gradient
DP_GRAD_TOL = 1e-2
DP_EVAL_SAMPLES = 8   # counterfactual samples per rank and variable, one batch


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


# phase 3c: the norm kernels at the pendulum UNet's shapes, (C, spatial) and
# the calls per UNet forward at that shape (of 62), bf16 unless marked
NORM_SHAPES = [(128, (96, 96), 10), (256, (96, 96), 3), (384, (96, 96), 1),
               (128, (48, 48), 1), (256, (48, 48), 9), (384, (48, 48), 1), (512, (48, 48), 2),
               (640, (48, 48), 1), (256, (24, 24), 1), (384, (24, 24), 9), (640, (24, 24), 1),
               (768, (24, 24), 2), (896, (24, 24), 1), (384, (12, 12), 1), (512, (12, 12), 13),
               (896, (12, 12), 1), (1024, (12, 12), 3), (512, (144,), 1)]
NORM_FP32 = (128, (96, 96), 1)   # the output norm
# the vector path's backward instantiations keep to 64 registers and spill
# 44-52 B (stack 48-56 B) at their measured times (NVIDIA H100 80GB HBM3,
# 700.00 W); more than this fails phase 3c
NORM_BWD_SPILL = 64


def norm_bound_ms(numel, esize, tensors):
    """Least time (ms) to move ``tensors`` full activations of ``numel``
    elements of ``esize`` bytes once each at the HBM rate (forward: x read, y
    written; backward: x and dy read, dx written)."""
    return tensors * numel * esize / PEAK_BYTES * 1e3


def check_norm(na, B, C, spatial, dtype, gen):
    """The norm kernels vs their plain versions at one shape (scale-shift and
    SiLU, as the ResBlocks call them; SiLU alone for the fp32 output norm),
    raising as phase 3c states, and their times beside the bound, the eager
    chain and the library's ``F.group_norm`` (the yardstick; the port never
    calls it). Returns the record."""
    import torch.nn.functional as F
    from _norm_reference import bwd_errors, bwd_magnitudes, chain_from_stats

    x = (1.5 * torch.randn(B, C, *spatial, generator=gen, device="cuda") + 0.3).to(dtype)
    dy = torch.randn(B, C, *spatial, generator=gen, device="cuda").to(dtype)
    w = 1.0 + 0.2 * torch.randn(C, generator=gen, device="cuda")
    b = 0.1 * torch.randn(C, generator=gen, device="cuda")
    ss = dtype == torch.bfloat16
    scale, shift = (torch.chunk((0.3 * torch.randn(B, 2 * C, generator=gen, device="cuda")
                                 ).to(dtype), 2, dim=-1) if ss else (None, None))
    args = (w, b, 32, 1e-5, scale, shift, True)
    what = f"norm on {(B, C, *spatial)} {dtype}"
    y, mean, rstd = na.norm_act_fwd(x, *args, with_stats=True)
    pm, pr = na.norm_act_stats_plain(x, 32, 1e-5)
    stats_err = max(float((mean - pm).abs().max()), float((rstd - pr).abs().max()))
    stats_ok = all(torch.allclose(k, p, rtol=1e-5, atol=1e-5)
                   for k, p in ((mean, pm), (rstd, pr)))
    on_stats = torch.equal(y, chain_from_stats(x, mean, rstd, w, b, scale, shift, True))
    want = na.norm_act_plain(x, *args)
    diff = (y.float() - want.float()).abs()
    equal = float((diff == 0).float().mean())
    got = na.norm_act_bwd(x, dy, *args, mean, rstd)
    again = na.norm_act_bwd(x, dy, *args, mean, rstd)
    plain = na.norm_act_bwd_plain(x, dy, *args, (mean, rstd))   # on the kernel's statistics
    excess = bwd_errors(got, plain, bwd_magnitudes(x, dy, w, b, scale, shift, True, mean, rstd))
    dx_err = float((got[0].float() - plain[0].float()).abs().max())
    dw_rel = float((got[1] - plain[1]).norm() / plain[1].norm())
    if not (stats_ok and on_stats):
        raise AssertionError(f"{what}: statistics {stats_err:.3e} from the plain ones (limit "
                             f"1e-5 + 1e-5 of them), output {'equal' if on_stats else 'not equal'} "
                             "to the eager chain's elementwise ops on them")
    if equal < 0.99 if ss else not torch.allclose(y, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{what}: {equal:.4f} of the elements equal the eager chain's, "
                             f"max abs difference {float(diff.max()):.3e}")
    if any(e is not None and e > 0 for e in excess):
        raise AssertionError(f"{what}: the backward (dx, d_weight, d_bias, d_scale, d_shift) "
                             f"exceeds one ulp + 1e-4 of its terms' magnitudes by {excess}")
    if not all(torch.equal(u, v) for u, v in zip(got[:3], again[:3])):
        raise AssertionError(f"{what}: two backward launches differ")
    numel, esize = x.numel(), x.element_size()
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    eager = lambda: na.norm_act_plain(*leaves, *args[2:])
    lib_w, lib_b = w.to(dtype).requires_grad_(True), b.to(dtype).requires_grad_(True)
    library = lambda: F.group_norm(leaves[0], 32, lib_w, lib_b, 1e-5)
    rec = {
        "shape": [B, C, *spatial], "dtype": str(dtype).removeprefix("torch."),
        "plan": na.plan(C, math.prod(spatial), 32, dtype),
        "equal_share": equal, "max_abs_err": float(diff.max()), "stats_err": stats_err,
        "dx_max_abs_err": dx_err, "d_weight_rel_err": dw_rel, "bwd_excess": excess,
        "fwd_ms": time_ms(lambda: na.norm_act_fwd(x, *args)),
        "fwd_stats_ms": time_ms(lambda: na.norm_act_fwd(x, *args, with_stats=True)),
        "bwd_ms": time_ms(lambda: na.norm_act_bwd(x, dy, *args, mean, rstd)),
        "fwd_bound_ms": norm_bound_ms(numel, esize, 2),
        "bwd_bound_ms": norm_bound_ms(numel, esize, 3),
        "eager_fwd_ms": time_ms(eager, iters=5),
        "eager_bwd_ms": max(time_ms(lambda: torch.autograd.grad(eager(), leaves, dy), iters=5)
                            - time_ms(eager, iters=5), 0.0),
        "library_fwd_ms": time_ms(library),
        "library_bwd_ms": max(time_ms(lambda: torch.autograd.grad(library(), leaves[:1], dy))
                              - time_ms(library), 0.0),
    }
    print(f"norm {rec['shape']} {rec['dtype']} plan {rec['plan']}: equal {equal:.5f}, max abs "
          f"err {rec['max_abs_err']:.3e}, stats err {stats_err:.2e}, dx max abs err "
          f"{dx_err:.3e}, d_weight rel err {dw_rel:.3e}; fwd {1e3 * rec['fwd_ms']:.1f} us "
          f"(with stats {1e3 * rec['fwd_stats_ms']:.1f}), bound {1e3 * rec['fwd_bound_ms']:.1f} us "
          f"({100 * rec['fwd_bound_ms'] / rec['fwd_ms']:.1f}%), eager chain "
          f"{1e3 * rec['eager_fwd_ms']:.1f}, F.group_norm {1e3 * rec['library_fwd_ms']:.1f}; "
          f"bwd {1e3 * rec['bwd_ms']:.1f} us, bound {1e3 * rec['bwd_bound_ms']:.1f} us "
          f"({100 * rec['bwd_bound_ms'] / rec['bwd_ms']:.1f}%), eager chain "
          f"{1e3 * rec['eager_bwd_ms']:.1f}, F.group_norm {1e3 * rec['library_bwd_ms']:.1f}",
          flush=True)
    return rec


def norm_phase(gen):
    """Phase 3c: the norm kernels built (ptxas's report), checked and timed
    at the pendulum UNet's shapes at the serving batch (16) and the training
    batch (32), as the module's docstring states; then one pendulum UNet
    forward without a gradient and one with a backward at batch 2, counting
    the norm launches (62 each way). Returns the records and the kernels'
    ptxas reports."""
    from causaldiffae_torch.config import create_model, get_config
    from causaldiffae_torch.ops import _build
    from causaldiffae_torch.ops import norm_act as na

    sys.path.insert(0, os.path.join(REPO, "tests"))   # _norm_reference: the card tests' bounds
    seconds, log = _build.build("norm_act")
    print(f"nvcc csrc/norm_act.cu: {seconds:.2f} s")
    ptxas = _build.ptxas_report(log)
    for r in ptxas:   # names as mangled: the demangler takes int arguments
        print(f"ptxas {r['name']}: {r['registers']} registers, spill {r['spill_stores']} B "
              f"stored / {r['spill_loads']} B loaded, stack {r['stack']} B, shared memory "
              f"{r['smem_static']} B static", flush=True)
    spilled = [r["name"] for r in ptxas if r["spill_stores"] > (
        NORM_BWD_SPILL if "norm_act_bwd_kernel" in r["name"] else 0)]
    if spilled or len(ptxas) < 9:
        raise AssertionError(f"norm kernels past their spill allowance: {spilled} (of "
                             f"{len(ptxas)} instantiations reported)")
    shapes = [(C, spatial, n, torch.bfloat16) for C, spatial, n in NORM_SHAPES]
    shapes.append((*NORM_FP32, torch.float32))
    recs = []
    for B in (32, 16):
        rows = [(n, check_norm(na, B, C, spatial, dtype, gen)) for C, spatial, n, dtype in shapes]
        recs += [r for _, r in rows]
        for key in ("fwd", "bwd"):
            ms, bound, eager = (sum(n * r[f"{k}_ms"] for n, r in rows)
                                for k in (key, f"{key}_bound", f"eager_{key}"))
            print(f"norm {key} at B={B}, the shapes above weighted by their calls "
                  f"({sum(n for n, _ in rows)} of 62): kernels {ms:.3f} ms, bound {bound:.3f} ms "
                  f"({100 * bound / ms:.1f}%), eager chain {eager:.3f} ms", flush=True)
    cfg = get_config("pendulum_causaldae")
    model = create_model(cfg, device="cuda")
    x = torch.randn(2, 96, 96, 4, generator=gen, device="cuda")
    t = torch.tensor([10, 500], device="cuda")
    z = torch.randn(2, cfg.rep_dim, generator=gen, device="cuda")
    nf, nb = na.norm_act_fwd.launches, na.norm_act_bwd.launches
    with torch.no_grad():
        model.denoise(x, t, z=z)
    torch.cuda.synchronize()
    serve_calls = na.norm_act_fwd.launches - nf
    nf = na.norm_act_fwd.launches
    model.denoise(x, t, z=z).float().square().mean().backward()
    torch.cuda.synchronize()
    train_calls = (na.norm_act_fwd.launches - nf, na.norm_act_bwd.launches - nb)
    print(f"pendulum UNet: {serve_calls} norm forward launches per call without a gradient, "
          f"{train_calls[0]} forward and {train_calls[1]} backward with one", flush=True)
    if serve_calls != 62 or train_calls != (62, 62):
        raise AssertionError("the pendulum UNet's 62 GroupNorm32 calls did not all launch the "
                             "norm kernels")
    del model
    torch.cuda.empty_cache()
    return {"fwd": recs, "ptxas": ptxas}


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
    """One step's loss gradients, every parameter, flattened to fp64. With
    dropout, every call draws the same masks (a generator seeded alike)."""
    from causaldiffae_torch.training.train_step import compute_losses

    cond = {k: v for k, v in batch.items() if k != "image"}
    masks = torch.Generator(device="cuda").manual_seed(SEED + 5)
    drop = lambda shape: torch.empty(shape, device="cuda").bernoulli_(  # noqa: E731
        1.0 - cfg.dropout, generator=masks)
    terms = compute_losses(cfg, model, diffusion, batch["image"], cond, draws["t"], 0.5,
                           noise=draws["noise"], rep_noise=draws["rep_noise"],
                           keep=draws["keep"], drop=drop)
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
    from causaldiffae_torch.ops import norm_act as na

    ops.attention_fwd.launches = ops.attention_fwd.lse_launches = 0
    ops.attention_bwd.launches = 0
    na.norm_act_fwd.launches = na.norm_act_bwd.launches = 0


def norm_counts():
    """(forward, backward) norm launches since the last reset."""
    from causaldiffae_torch.ops import norm_act as na

    return [na.norm_act_fwd.launches, na.norm_act_bwd.launches]


def norms_match(path, name, attn, norms=None, remat=False):
    """Record ``norms`` (default: :func:`norm_counts`) under ``path`` and hold
    them to the attention launches ``attn`` (forward, with lse, backward) of
    the same path on preset ``name``: one forward per ``GroupNorm32`` for each
    UNet call that the attention forwards count (at least that under remat,
    which runs a ResBlock's forward again), one backward per norm for each
    attention backward's call."""
    norms = list(norm_counts() if norms is None else norms)
    NORM_BY_PATH[path] = norms
    a, n = ATTN_PER_CALL[name], NORMS_PER_CALL[name]
    fwd_ok = norms[0] * a >= attn[0] * n if remat else norms[0] * a == attn[0] * n
    if not (norms[0] and fwd_ok and norms[1] * a == attn[2] * n):
        NORM_FAULTS.append(f"{path}: norm launches {norms} beside attention launches "
                           f"{list(attn)}, expected {n} norms per {a} attention blocks")
        print(f"NORM LAUNCH FAULT {NORM_FAULTS[-1]}", flush=True)
    return norms


def counts(ops):
    """(forward, forward writing lse, backward) launches since the last reset."""
    return (ops.attention_fwd.launches, ops.attention_fwd.lse_launches,
            ops.attention_bwd.launches)


def gradient_check(cfg, ops, gen, seed):
    """One step's gradient at batch GRAD_BATCH with the kernels, with their
    plain versions and with fp64 attention, on the same random weights,
    batch and draws, for GRAD_DRAWS draws: the kernels' may stand at most
    1.5x as far from the fp64 one as the plain versions' (RMS over all
    parameters and the draws). One gradient launches each kernel once per
    attention block, every forward writing lse."""
    from causaldiffae_torch.config import create_diffusion, create_model
    from causaldiffae_torch.data import synthetic_dataset
    from causaldiffae_torch.training.loop import to_device

    diffusion = create_diffusion(cfg)
    model = create_model(cfg, device="cuda").train()
    fill_weights_(model, seed)
    B, s = GRAD_BATCH, cfg.image_size
    batch = to_device(synthetic_dataset(cfg.dataset, B, seed=SEED, image_size=s), "cuda")
    n = ATTN_PER_CALL[cfg.name]
    dists = []  # (kernels, plain, kernels vs plain) per draw
    names, sizes = zip(*((name, p.numel()) for name, p in model.named_parameters()))
    by_tensor = torch.zeros(2, len(sizes), dtype=torch.float64)  # squared distances
    for _ in range(GRAD_DRAWS):
        draws = {"t": torch.randint(0, diffusion.num_timesteps, (B,), generator=gen,
                                    device="cuda"),
                 "noise": torch.randn(B, s, s, cfg.in_channels, generator=gen, device="cuda"),
                 "rep_noise": torch.randn(B, cfg.rep_dim, generator=gen, device="cuda"),
                 "keep": torch.tensor([1.0, 0.0] * (B // 2), device="cuda")}
        before = counts(ops)
        g_kernel = training_gradients(cfg, model, diffusion, batch, draws)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(counts(ops), before))
        if launched != (n, n, n):
            raise AssertionError(f"one full-width {cfg.name} gradient launched {launched} "
                                 f"(forward, forward with lse, backward) attention kernels, "
                                 f"expected {n} each")
        if not bool(torch.isfinite(g_kernel).all()):
            raise AssertionError("the kernels' full-width gradient is not finite")
        with route_attention(PlainAttention.apply):
            g_plain = training_gradients(cfg, model, diffusion, batch, draws)
        with route_attention(lambda qkv, heads: exact_attention(ops, qkv, heads)[0]
                             .to(qkv.dtype)):
            g_exact = training_gradients(cfg, model, diffusion, batch, draws)
        dists.append((rms(g_kernel - g_exact), rms(g_plain - g_exact), rms(g_kernel - g_plain)))
        for i, g in enumerate((g_kernel, g_plain)):
            by_tensor[i] += torch.stack([part.pow(2).sum() for part in
                                         torch.split(g - g_exact, sizes)]).cpu()
        scale = rms(g_exact)
        del g_kernel, g_plain, g_exact
    d_k, d_p = (math.sqrt(sum(d[i] ** 2 for d in dists) / len(dists)) for i in (0, 1))
    share = by_tensor / by_tensor.sum(dim=1, keepdim=True)
    top = int(share[0].argmax())
    print(f"{cfg.name}: full-width gradient at B={B}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {GRAD_DRAWS} draws: rms "
          f"{scale:.4e}; rms distance from the gradient with fp64 attention: kernels {d_k:.4e}, "
          f"plain {d_p:.4e} (ratio {d_k / d_p:.3f}, limit 1.5); by draw (kernels, plain, "
          f"kernels vs plain) {[tuple(f'{x:.3e}' for x in d) for d in dists]} (ratios "
          f"{[round(d[0] / d[1], 3) for d in dists]}); largest share of the squared distance: "
          f"{names[top]} ({sizes[top]} values), {float(share[0, top]):.3f} of the kernels', "
          f"{float(share[1, top]):.3f} of the plain's; launches per gradient {launched}",
          flush=True)
    if d_k > 1.5 * d_p:
        raise AssertionError("the kernels' full-width gradient stands farther from the "
                             "fp64-attention gradient than the plain version's allows")
    del model
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
    norms_match("training", cfg.name, counts(ops))
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
    tag = name.split("_")[0]
    norms_match(f"training_{tag}", name, train_counts)
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
    norms_match(f"serving_{tag}", name, counts(ops))
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
    norms_match("evaluation" + ("" if name.startswith("morpho") else f"_{name.split('_')[0]}"),
                name, counts(ops))
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
    norms_match("nll", cfg.name, counts(ops))
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
    norms_match("prior_sampling", cfg.name, counts(ops))
    print(f"sample: 16 prior samples, DPM++-25, {calls[0]} UNet calls in {seconds:.3f} s, "
          f"{sample_fwd} forward launches, none with lse", flush=True)
    return {"nll": nll_fwd, "prior_sampling": sample_fwd}


def step_device_ms(cfg, steps=5):
    """Device time of one train step at the preset's batch (ms): the sum of
    kernel times under torch.profiler over ``steps`` steps on one batch, after
    2 warm-up steps, the weights filled; None where the trace holds no device
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.data import synthetic_dataset
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import to_device

    state = create_train_state(cfg, dp_model(cfg))
    step = make_train_step(cfg, state.model, create_diffusion(cfg), state.optimizer)
    batch = to_device(synthetic_dataset(cfg.dataset, cfg.batch_size, seed=SEED,
                                        image_size=cfg.image_size), "cuda")
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events if e.self_device_time_total > 0)
    del state, step
    torch.cuda.empty_cache()
    return (us / 1e3 / steps, launches / steps) if us > 0 else (None, None)


def train_state(state):
    """Every tensor of a train state (the model's, the optimizer's, the EMA)."""
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "ema": state.ema}


def flow_dropout_phase(ops, gen, work):
    """Phase 12: the flow prior and dropout at full width. The gradient check
    at batch 16, then 4 steps of the train loop at the preset's batch, and 2
    steps with a checkpoint and a resume to step 4 that must end bit-equal
    to them (the dropout masks come from the step's generator). Returns the
    kernels' launches in the 4 steps."""
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.data import batch_iterator, synthetic_dataset
    from causaldiffae_torch.serve import build_model
    from causaldiffae_torch.training import run_training
    from causaldiffae_torch.utils.determinism import differences, pin

    pin()  # the train CLI's setting, under which a rerun gives the same bits
    cfg = get_config("morphomnist_causaldae").replace(**FLOW_DROPOUT)
    gradient_check(cfg, ops, gen, SEED + 6)
    diffusion = create_diffusion(cfg)
    pool = synthetic_dataset(cfg.dataset, POOL, seed=SEED, image_size=cfg.image_size)
    data = lambda skip=0: itertools.islice(  # noqa: E731
        batch_iterator(pool, cfg.batch_size, seed=SEED + 1), skip, None)

    def model():
        m = build_model(cfg, "", SEED, "cuda")
        fill_weights_(m, SEED + 7)
        return m

    m = model()
    flow0 = {n: p.detach().clone() for n, p in m.causal_flow.named_parameters()}
    stamps = SyncedStamps(data())
    reset_counts(ops)  # this path's count
    torch.cuda.reset_peak_memory_stats()
    straight, records = run_training(cfg, m, diffusion, stamps, total_steps=4, log_interval=1,
                                     device="cuda")
    launches = counts(ops)
    norms_match("training_flow_dropout", cfg.name, launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_records("flow + dropout", records, range(1, 5))
    if launches != (8 * 4,) * 3:
        raise AssertionError(f"flow + dropout: (forward, with lse, backward) launches {launches} "
                             "in 4 steps, expected 8 of each per step")
    still = [n for n, p in straight.model.causal_flow.named_parameters()
             if torch.equal(p.detach(), flow0[n])]
    if still:
        raise AssertionError(f"flow parameters that did not move: {still}")
    ckpt = os.path.join(work, "flow-ckpt")
    run_training(cfg, model(), diffusion, data(), total_steps=2, log_interval=1, device="cuda",
                 ckpt_dir=ckpt)
    resumed, second = run_training(cfg, model(), diffusion, data(2), total_steps=4,
                                   log_interval=1, device="cuda", ckpt_dir=ckpt)
    check_records("flow + dropout, resumed", second, range(3, 5))
    differ = differences(train_state(straight), train_state(resumed))
    shutil.rmtree(ckpt)
    if differ:
        raise AssertionError(f"flow + dropout: steps 3-4 after a resume differ from a straight "
                             f"run in {len(differ)} tensors, e.g. {sorted(differ)[:3]}")
    step_ms = [1e3 * (b - a) for a, b in zip(stamps.stamps, stamps.stamps[1:])]
    step_s = sum(step_ms[2:]) / len(step_ms[2:]) / 1e3
    base = get_config("morphomnist_causaldae")
    device = {name: step_device_ms(c) for name, c in (
        ("flagship", base), ("flow", base.replace(flow_based=True, masking=False)),
        ("dropout", base.replace(dropout=FLOW_DROPOUT["dropout"])), ("flow + dropout", cfg))}
    print("train step device time at batch 128 (torch.profiler, kernel sum, 5 steps; ms, "
          "launches per step): " + ", ".join(
              f"{k} {v[0]:.2f} ms, {v[1]:.0f} launches" if v[0] else f"{k} not measured"
              for k, v in device.items()), flush=True)
    n_flow = sum(p.numel() for p in straight.model.causal_flow.parameters())
    print(f"flow + dropout {FLOW_DROPOUT}, {sum(p.numel() for p in m.parameters())} parameters "
          f"({n_flow} in the flow), batch {cfg.batch_size}, 4 steps: loss "
          f"{[round(r['loss'], 4) for r in records]}, kld_rep "
          f"{[round(r['kld_rep'], 2) for r in records]}; step ms (host clock between device "
          f"syncs) {[round(t, 2) for t in step_ms]}, steady {1e3 * step_s:.2f} ms "
          f"({cfg.batch_size / step_s:.1f} samples/s); launches {launches}; peak memory "
          f"{peak_gb:.3f} GB; every flow parameter moved; steps 3-4 after a checkpoint at 2 "
          f"and a resume bit-equal to the straight run", flush=True)
    return {"attention_fwd": launches[0], "attention_bwd": launches[2]}


def torchrun_phase(work):
    """Phase 13a: the train CLI under ``torch.distributed.run`` at world size 1
    (NCCL, the model in DDP) and the plain CLI, 2 steps each in fresh
    processes started together: their checkpoints must be bit-equal."""
    from causaldiffae_torch.training import CheckpointManager
    from causaldiffae_torch.utils.determinism import differences, tensors

    dirs = {k: os.path.join(work, f"torchrun-{k}") for k in ("plain", "torchrun")}
    args = REPEAT_TRAIN + ["--ckpt_dir"]
    cmds = {"plain": [sys.executable, "-m", "causaldiffae_torch.train", *args, dirs["plain"]],
            "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", "1", "-m", "causaldiffae_torch.train", *args,
                         dirs["torchrun"]]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                 text=True) for k, c in cmds.items()}
    try:
        for k, p in procs.items():
            _, err = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"the {k} train CLI exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    saved = {k: CheckpointManager(d).load() for k, d in dirs.items()}
    differ = differences(saved["plain"], saved["torchrun"])
    n = len(dict(tensors(saved["plain"])))
    for d in dirs.values():
        shutil.rmtree(d)
    print(f"torchrun --nproc_per_node 1 (NCCL, DDP at W = 1) against the plain train CLI, 2 "
          f"steps each in fresh processes, {time.perf_counter() - t0:.1f} s: "
          f"{len(differ)} of {n} checkpoint tensors differ", flush=True)
    if differ or saved["plain"]["step"] != 2:
        raise AssertionError(f"the checkpoint under torchrun differs from the plain CLI's in "
                             f"{sorted(differ)[:5]}")


def dp_model(cfg):
    """The data-parallel phase's weights: the seeded init, every weight filled."""
    from causaldiffae_torch.serve import build_model

    model = build_model(cfg, "", SEED, "cuda")
    fill_weights_(model, SEED + 8)
    return model


def flat_grads(model):
    return torch.cat([p.grad.detach().float().reshape(-1) for p in model.parameters()]).cpu()


def dp_rank(rank, world, store, work, ckpt):
    """One of phase 13b's ranks (a fresh process on the card, gloo): the first
    train step on this rank's share of the global batch with the model in
    DDP, then 3 more timed; then the ``counterfactual_test`` CLI on ``ckpt``.
    Writes its gradient to ``<work>/dp-grad-<rank>.pt`` and prints one JSON
    line per part."""
    import torch.distributed as dist

    from causaldiffae_torch import counterfactual_test
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.ops import attention as ops
    from causaldiffae_torch.parallel import rank_rows
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import to_device, wrap_model

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent process runs
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    cfg = get_config("morphomnist_causaldae")
    state = create_train_state(cfg, dp_model(cfg))
    step = make_train_step(cfg, wrap_model(cfg, state.model, "cuda"), create_diffusion(cfg),
                           state.optimizer)
    with np.load(os.path.join(work, "dp-batch.npz")) as z:
        rows = rank_rows(cfg.batch_size, world, rank)
        batch = to_device({k: z[k][rows] for k in z.files}, "cuda")
    reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.save(flat_grads(state.model), os.path.join(work, f"dp-grad-{rank}.pt"))
    launches, norms = counts(ops), norm_counts()
    times = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"rank": rank, "part": "train", "first_step_s": first_s,
                      "step_ms": times, "launches": launches, "norms": norms,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    del state, step
    torch.cuda.empty_cache()
    dist.barrier()

    wrote = []  # the files this rank writes
    np_savez, grid = np.savez, counterfactual_test.save_grid
    np.savez = lambda path, *a, **k: (wrote.append(os.path.basename(path)),
                                      np_savez(path, *a, **k))
    counterfactual_test.save_grid = lambda x, path, **k: (wrote.append(os.path.basename(path)),
                                                          grid(x, path, **k))
    save_best = counterfactual_test.ClassifierTrainer.save_best
    counterfactual_test.ClassifierTrainer.save_best = lambda self, path: (
        wrote.append(os.path.basename(path)), save_best(self, path))
    reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = counterfactual_test.main(["--ckpt_dir", ckpt, "--synthetic", "--num_samples",
                                       str(DP_EVAL_SAMPLES), "--batch_size",
                                       str(DP_EVAL_SAMPLES), "--clf_epochs", str(CLF_EPOCHS),
                                       "--sampler", "dpm++", "--sample_steps", "25",
                                       "--out_dir", os.path.join(work, "dp-eval"),
                                       "--seed", str(SEED)])
    print(json.dumps({"rank": rank, "part": "eval", "result": result, "wrote": wrote,
                      "seconds": time.perf_counter() - t0, "launches": counts(ops),
                      "norms": norm_counts(),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    dist.destroy_process_group()


def data_parallel_phase(ops, work, ckpt):
    """Phase 13b: two gloo ranks on the one card (NCCL takes one rank per
    device). The first train step at the preset's global batch of 128, 64
    rows per rank, against one process at 128 on the same global draws: the
    all-reduced gradient within DP_GRAD_TOL (relative L2) of the one-process
    gradient, and bit-equal on the two ranks. Then ``counterfactual_test``
    on the two ranks: the same JSON on both, only rank 0 writes, a finite
    MAE, the samples of both ranks in the archive. Returns rank 0's launches
    by path."""
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.data import batch_iterator, synthetic_dataset
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import to_device

    cfg = get_config("morphomnist_causaldae")
    pool = synthetic_dataset(cfg.dataset, POOL, seed=SEED, image_size=cfg.image_size)
    batch = next(batch_iterator(pool, cfg.batch_size, seed=SEED + 1))
    np.savez(os.path.join(work, "dp-batch.npz"), **batch)
    state = create_train_state(cfg, dp_model(cfg))
    t0 = time.perf_counter()
    make_train_step(cfg, state.model, create_diffusion(cfg), state.optimizer)(
        state, to_device(batch, "cuda"))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    want = flat_grads(state.model).double()
    del state
    torch.cuda.empty_cache()

    store = os.path.join(work, "dp-store")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke\nchip_smoke.dp_rank({r}, 2, {store!r}, "
                               f"{work!r}, {ckpt!r})\n"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=900)
            if p.returncode:
                raise AssertionError(f"data-parallel rank {r} exited {p.returncode}:\n"
                                     f"{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    reports = [{rec["part"]: rec for rec in map(json.loads, (line for line in out.splitlines()
                                                             if line.startswith('{"rank"')))}
               for out in outs]
    got = [torch.load(os.path.join(work, f"dp-grad-{r}.pt")).double() for r in range(2)]
    if not torch.equal(got[0], got[1]):
        raise AssertionError("the two ranks hold different all-reduced gradients")
    dist_rel = float((got[0] - want).norm() / want.norm())
    train = [rep["train"] for rep in reports]
    print(f"data parallel, 2 gloo ranks on one card, global batch {cfg.batch_size} (64 per "
          f"rank), first step: relative L2 distance of the all-reduced gradient from one "
          f"process's {dist_rel:.3e} (limit {DP_GRAD_TOL}); one process's step "
          f"{one_s:.3f} s; per rank: first step {[round(t['first_step_s'], 3) for t in train]} s, "
          f"steps 2-4 ms (two processes sharing the card) "
          f"{[[round(x, 1) for x in t['step_ms']] for t in train]}, launches "
          f"{[t['launches'] for t in train]}, peak memory "
          f"{[round(t['peak_gb'], 3) for t in train]} GB", flush=True)
    if not dist_rel <= DP_GRAD_TOL:
        raise AssertionError(f"the data-parallel gradient stands {dist_rel:.3e} from one "
                             f"process's (relative L2), limit {DP_GRAD_TOL}")
    n = ATTN_PER_CALL[cfg.name]
    if any(t["launches"] != [n, n, n] for t in train):
        raise AssertionError(f"a rank's first step launched {[t['launches'] for t in train]} "
                             f"attention kernels, expected {n} of each")
    ev = [rep["eval"] for rep in reports]
    mae = {k: v for k, v in ev[0]["result"].items() if k.startswith("mae_")}
    with np.load(os.path.join(work, "dp-eval", "samples_do_thickness.npz")) as z:
        stamp, rows = int(z["process_count"]), z["samples"].shape[0]
    print(f"data parallel counterfactual_test, 2 ranks, {DP_EVAL_SAMPLES} samples each "
          f"through DPM++-25: {seconds:.1f} s for both parts; evaluation "
          f"{[round(e['seconds'], 1) for e in ev]} s, peak memory "
          f"{[round(e['peak_gb'], 3) for e in ev]} GB; result {ev[0]['result']}; rank 0 "
          f"wrote {sorted(ev[0]['wrote'])}, rank 1 wrote {ev[1]['wrote']}; archive "
          f"process_count {stamp}, {rows} samples", flush=True)
    if ev[0]["result"] != ev[1]["result"] or ev[1]["wrote"] or not ev[0]["wrote"] \
            or not all(math.isfinite(v) for v in mae.values()) or len(mae) != 2 \
            or (stamp, rows) != (2, 2 * DP_EVAL_SAMPLES):
        raise AssertionError("data-parallel evaluation: the ranks' results differ, rank 1 wrote, "
                             "the MAE is not finite or the archive is not both ranks'")
    shutil.rmtree(os.path.join(work, "dp-eval"))
    for r in range(2):
        norms_match(f"training_dp_rank{r}", cfg.name, train[r]["launches"], train[r]["norms"])
        norms_match(f"evaluation_dp_rank{r}", cfg.name, ev[r]["launches"], ev[r]["norms"])
    return {"training_dp": train[0]["launches"], "evaluation_dp": ev[0]["launches"]}


TP_STEPS = 3          # phase 16a: step 1, a checkpoint, then a resume to step 3
# phase 16a: in bf16 on random filled weights the gradient moves ~2e-2 (relative
# L2) under any rounding change: the plain attention's stands 1.862e-2 from the
# kernels' in one process, and tp = 2 2.202e-2 from one process (this phase;
# NVIDIA H100 80GB HBM3, 700.00 W), where in fp32 it stands 4.0e-6. So in bf16
# tp = 2 may stand 1.5x as far from one process as the plain attention does;
# in fp32 it is held to DP_GRAD_TOL.
TP_ROUTE_RATIO = 1.5


def tp_rank(rank, world, store, work):
    """One of phase 16a's ranks (a fresh process on the card, gloo, tp = 2,
    dp = 1, remat on): ``run_training`` to step 1 and a checkpoint, the
    step's gradient gathered from the shards, then a fresh full-width model
    that the loop cuts again, resumes from that checkpoint and trains to
    step TP_STEPS; then the first step of the fp32 model, cut alike.
    Writes the two gradients to ``<work>/tp-grad-<rank>.pt`` and
    ``<work>/tp32-grad-<rank>.pt`` and prints one JSON line."""
    import torch.distributed as dist

    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.ops import attention as ops
    from causaldiffae_torch.parallel.collectives import TP_ALL_REDUCES
    from causaldiffae_torch.parallel.partition import (gather_state_dict, shard_model_,
                                                       unet_shard_plan)
    from causaldiffae_torch.training import create_train_state, make_train_step, run_training
    from causaldiffae_torch.training.loop import to_device
    from causaldiffae_torch.utils import determinism

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent process runs
    torch.backends.cudnn.allow_tf32 = False
    determinism.pin()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    cfg = get_config("morphomnist_causaldae").replace(model_parallel=2, use_remat=True,
                                                      save_interval=2)
    with np.load(os.path.join(work, "tp-batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    ckpt = os.path.join(work, "tp-ckpt")
    diffusion = create_diffusion(cfg)
    reset_counts(ops)  # the main path's count
    TP_ALL_REDUCES.update(dict.fromkeys(TP_ALL_REDUCES, 0))
    model = dp_model(cfg)
    t0 = time.perf_counter()
    _, first = run_training(cfg, model, diffusion, iter([batch] * 2), total_steps=1,
                            log_interval=1, device="cuda", ckpt_dir=ckpt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    plan = model.shard_plan
    grads = gather_state_dict({n: p.grad for n, p in model.named_parameters()}, plan)
    torch.save(torch.cat([grads[n].float().reshape(-1).cpu() for n in grads]),
               os.path.join(work, f"tp-grad-{rank}.pt"))
    del model, grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = SyncedStamps(iter([batch] * (TP_STEPS + 1)))
    state, records = run_training(cfg, dp_model(cfg), diffusion, data, total_steps=TP_STEPS,
                                  log_interval=1, device="cuda", ckpt_dir=ckpt)
    launches, norms = counts(ops), norm_counts()
    check_records(f"tp rank {rank}", first + records, range(1, TP_STEPS + 1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    all_reduces = dict(TP_ALL_REDUCES)
    del state
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(use_bf16=False)
    model = dp_model(cfg32)
    shard_model_(model, unet_shard_plan(model, 2))
    state32 = create_train_state(cfg32, model)
    make_train_step(cfg32, model, diffusion, state32.optimizer)(state32,
                                                                to_device(batch, "cuda"))
    grads = gather_state_dict({n: p.grad for n, p in model.named_parameters()}, plan)
    torch.save(torch.cat([grads[n].float().reshape(-1).cpu() for n in grads]),
               os.path.join(work, f"tp32-grad-{rank}.pt"))
    print(json.dumps({
        "rank": rank, "blocks": len(plan.blocks), "leaves": len(plan.leaves),
        "first_step_s": first_s, "resumed_at": records[0]["step"] - 1,
        "step_ms": [1e3 * (b - a) for a, b in zip(data.stamps, data.stamps[1:])],
        "launches": launches, "norms": norms, "all_reduces": all_reduces, "peak_gb": peak_gb,
        "loss": [r["loss"] for r in first + records],
        "params": sum(p.numel() for p in model.parameters())}), flush=True)
    dist.destroy_process_group()


def route_gradient(cfg, batch, route=None):
    """The first train step's gradient (fp64, flat, named_parameters' order)
    of one process at the preset's batch on phase 16's weights, with the
    attention through ``route`` when given."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import to_device

    state = create_train_state(cfg, dp_model(cfg))
    step = make_train_step(cfg, state.model, create_diffusion(cfg), state.optimizer)
    with route_attention(route) if route else contextlib.nullcontext():
        step(state, to_device(batch, "cuda"))
    grads = flat_grads(state.model).double()
    del state, step
    torch.cuda.empty_cache()
    return grads


def tensor_parallel_phase(ops, work, card_line):
    """Phase 16a: tensor parallelism at full width, two gloo ranks on the one
    card (tp = 2, dp = 1; NCCL takes one rank per device), remat on. The
    first step's gradient, gathered from the shards and bit-equal on both
    ranks, against one process's on the same weights and draws: with the
    kernels in bf16, no farther from the gradient with fp64 attention than
    1.5x the plain attention's, and no farther from one process's than 1.5x
    the plain attention's gradient stands from the kernels' in one process
    (TP_ROUTE_RATIO); in fp32 (plain attention), within DP_GRAD_TOL of one
    process's. The tp = 2 checkpoint against a one-process run's: the same
    keys and shapes, the params within DP_GRAD_TOL. Launches, all-reduces,
    peak memory and step time per rank. Returns rank 0's launches in its
    run (forward, with lse, backward)."""
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.data import batch_iterator, synthetic_dataset
    from causaldiffae_torch.training import CheckpointManager, run_training
    from causaldiffae_torch.utils.determinism import tensors

    cfg = get_config("morphomnist_causaldae")
    pool = synthetic_dataset(cfg.dataset, POOL, seed=SEED, image_size=cfg.image_size)
    batch = next(batch_iterator(pool, cfg.batch_size, seed=SEED + 1))
    np.savez(os.path.join(work, "tp-batch.npz"), **batch)
    t0 = time.perf_counter()
    want = route_gradient(cfg, batch)
    plain = route_gradient(cfg, batch, PlainAttention.apply)
    exact = route_gradient(cfg, batch, lambda qkv, heads: exact_attention(ops, qkv, heads)[0]
                           .to(qkv.dtype))
    want32 = route_gradient(cfg.replace(use_bf16=False), batch)
    one_ckpt = os.path.join(work, "tp1-ckpt")
    run_training(cfg, dp_model(cfg), create_diffusion(cfg), iter([batch] * (TP_STEPS + 1)),
                 total_steps=TP_STEPS, log_interval=1, device="cuda", ckpt_dir=one_ckpt)
    refs_s = time.perf_counter() - t0

    store = os.path.join(work, "tp-store")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke\nchip_smoke.tp_rank({r}, 2, {store!r}, "
                               f"{work!r})\n"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"tensor-parallel rank {r} exited {p.returncode}:\n"
                                     f"{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    reps = [json.loads(next(line for line in out.splitlines() if line.startswith('{"rank"')))
            for out in outs]
    got, got32 = ([torch.load(os.path.join(work, f"{tag}-grad-{r}.pt")).double()
                   for r in range(2)] for tag in ("tp", "tp32"))
    if not (torch.equal(got[0], got[1]) and torch.equal(got32[0], got32[1])):
        raise AssertionError("the two TP ranks hold different gradients (gathered)")
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    dist_rel, routes_rel, dist32 = rel(got[0], want), rel(plain, want), rel(got32[0], want32)
    d_tp, d_one, d_plain = rms(got[0] - exact), rms(want - exact), rms(plain - exact)
    saved = CheckpointManager(os.path.join(work, "tp-ckpt")).load(TP_STEPS)
    one = CheckpointManager(one_ckpt).load(TP_STEPS)
    shapes = [{p: tuple(v.shape) for p, v in tensors(s)} for s in (saved, one)]
    flat = lambda s: torch.cat([v.double().reshape(-1) for v in s["model"].values()])  # noqa
    ckpt_rel = float((flat(saved) - flat(one)).norm() / flat(one).norm())
    per_step = [{k: v / TP_STEPS for k, v in rep["all_reduces"].items()} for rep in reps]
    launches = [[n // TP_STEPS for n in rep["launches"]] for rep in reps]
    print(f"{card_line}: tensor parallel, tp = 2 on 2 gloo ranks on one card, "
          f"{cfg.name} at batch {cfg.batch_size}, remat on; {reps[0]['blocks']} ResBlocks "
          f"sharded ({reps[0]['leaves']} parameters), {reps[0]['params']} parameters per rank; "
          f"first step's gradient: relative L2 from one process's {dist_rel:.3e} (limit "
          f"{TP_ROUTE_RATIO} x {routes_rel:.3e}, the plain attention's from the kernels' in one "
          f"process: ratio {dist_rel / routes_rel:.3f}), in fp32 {dist32:.3e} (limit "
          f"{DP_GRAD_TOL}); rms distance from the gradient with fp64 attention: tp {d_tp:.4e}, "
          f"one process with the kernels {d_one:.4e}, plain attention {d_plain:.4e} (tp / plain "
          f"{d_tp / d_plain:.3f}, limit 1.5); gradients bit-equal on the ranks; checkpoint at "
          f"step {TP_STEPS} (resumed at step {reps[0]['resumed_at']}): {len(shapes[0])} tensors, "
          f"keys and shapes {'equal' if shapes[0] == shapes[1] else 'DIFFERENT'} to one "
          f"process's, params relative L2 {ckpt_rel:.3e}; per rank per step: launches "
          f"(forward, with lse, backward) {launches}, TP all-reduces {per_step}; wall ms per "
          f"step (steps 2-{TP_STEPS}, host clock between device syncs, two processes sharing "
          f"the card) {[[round(x, 1) for x in rep['step_ms']] for rep in reps]}; first step "
          f"with start-up {[round(rep['first_step_s'], 2) for rep in reps]} s; peak memory "
          f"{[round(rep['peak_gb'], 3) for rep in reps]} GB; loss "
          f"{[round(x, 5) for x in reps[0]['loss']]}; {seconds:.1f} s for the ranks, "
          f"{refs_s:.1f} s for the one-process references", flush=True)
    if not dist_rel <= TP_ROUTE_RATIO * routes_rel or d_tp > 1.5 * d_plain \
            or not dist32 <= DP_GRAD_TOL:
        raise AssertionError("the tensor-parallel gradient stands too far from one process's")
    if shapes[0] != shapes[1] or not ckpt_rel <= DP_GRAD_TOL:
        raise AssertionError("the tp = 2 checkpoint is not a one-process checkpoint")
    n = ATTN_PER_CALL[cfg.name]
    if any(lc != [n, n, n] for lc in launches) or reps[0]["blocks"] != 23 \
            or any(rep["resumed_at"] != 1 for rep in reps):
        raise AssertionError(f"tensor parallel: launches per step {launches} (expected {n} of "
                             f"each), {reps[0]['blocks']} sharded blocks (expected 23)")
    for r, tag in itertools.product(range(2), ("tp", "tp32")):
        os.remove(os.path.join(work, f"{tag}-grad-{r}.pt"))
    shutil.rmtree(os.path.join(work, "tp-ckpt"))
    shutil.rmtree(one_ckpt)
    for r, rep in enumerate(reps):
        norms_match(f"training_tp_rank{r}", cfg.name, rep["launches"], rep["norms"], remat=True)
    return reps[0]["launches"]


def remat_phase(work, card_line):
    """Phase 16b: the flagship at the preset's batch with and without
    ``use_remat``: the first step on a fresh state from phase 16's weights,
    each side's loss and gradients the same (bit for bit under
    ``determinism.pin``, else within DP_GRAD_TOL) and its peak memory; then
    the device time per step (``step_device_ms``) in turns (off, on, on,
    off)."""
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import to_device
    from causaldiffae_torch.utils import determinism

    determinism.pin()
    base = get_config("morphomnist_causaldae")
    with np.load(os.path.join(work, "tp-batch.npz")) as z:
        batch = to_device({k: z[k] for k in z.files}, "cuda")

    def first_step(remat):
        cfg = base.replace(use_remat=remat)
        state = create_train_state(cfg, dp_model(cfg))
        step = make_train_step(cfg, state.model, create_diffusion(cfg), state.optimizer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(step(state, batch)["loss"])
        out = loss, flat_grads(state.model), torch.cuda.max_memory_allocated() / 1e9
        del state, step
        torch.cuda.empty_cache()
        return out

    (loss_off, g_off, peak_off), (loss_on, g_on, peak_on) = first_step(False), first_step(True)
    same = torch.equal(g_off, g_on) and loss_off == loss_on
    rel = float((g_on.double() - g_off.double()).norm() / g_off.double().norm())
    device = {False: [], True: []}
    for remat in (False, True, True, False):
        device[remat].append(step_device_ms(base.replace(use_remat=remat), steps=3)[0])
    print(f"{card_line}: remat, {base.name} at batch {base.batch_size}: first step's loss and "
          f"gradients {'bit-equal' if same else 'DIFFER'} with and without it (relative L2 "
          f"{rel:.3e}; loss {loss_off!r} / {loss_on!r}); peak device memory of the first "
          f"step without {peak_off:.3f} GB, with {peak_on:.3f} GB; device ms per step "
          f"(torch.profiler's kernel sum over 3 steps, in turns off, on, on, off) without "
          f"{[round(x, 2) for x in device[False]]}, with {[round(x, 2) for x in device[True]]}",
          flush=True)
    if not rel <= DP_GRAD_TOL:
        raise AssertionError(f"remat moved the gradient by {rel:.3e} (relative L2)")


ARTIFACT_BATCH = 16
ARTIFACT_REQUESTS = 48   # 3 batches of 16 per serving route
DDIM_STEPS = 250         # morphomnist's eval respacing: UNet calls per DDIM chain


def served_artifact(ops, serve_artifact, artifact, label, argv, calls_per_chain, per_call):
    """``serve_artifact.main`` on ``ARTIFACT_REQUESTS`` synthetic requests in
    this process, with the launch counts reset before and read after: the
    forward kernel ``per_call`` times per UNet call of every chain run
    (the prewarm's included), none writing lse, no backward. Returns the report."""
    out = artifact + f".{label}.npz"
    reset_counts(ops)
    rep = serve_artifact.main(["--artifact", artifact, "--synthetic", str(ARTIFACT_REQUESTS),
                               "--value", "1.0", "--out", out, *argv])
    chains = ARTIFACT_REQUESTS // rep["batch"] + ("--prewarm" in argv)
    want = per_call * calls_per_chain * chains
    if counts(ops) != (want, 0, 0) or rep["attention_launches"] != want:
        raise AssertionError(f"{label}: (forward, with lse, backward) launches {counts(ops)} "
                             f"for {chains} chains of {calls_per_chain} UNet calls, expected "
                             f"{per_call} forward per call")
    norms_match(f"artifact_{label}", "morphomnist_causaldae", counts(ops))
    if rep["norm_launches"] != norm_counts()[0]:
        NORM_FAULTS.append(f"artifact_{label}: the report's {rep['norm_launches']} norm "
                           f"launches against the counter's {norm_counts()[0]}")
    check_samples(label, out, (ARTIFACT_REQUESTS, 28, 28, 1))
    return rep


FRESH_CONSUMER = """
import json, sys
import torch
import causaldiffae_torch.serving
from causaldiffae_torch import serve_artifact
report = serve_artifact.main(sys.argv[1:])
banned = [m for m in sys.modules if m.startswith(("causaldiffae_torch.models",
          "causaldiffae_torch.diffusion", "causaldiffae_torch.evals", "causaldiffae_torch.config",
          "causaldiffae_tpu", "jax"))]
if banned:
    raise SystemExit(f"the consumer loaded model code: {banned}")
print("FRESH " + json.dumps(report))
"""


EXPORTER = """
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from causaldiffae_torch import export_serving
for argv in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    export_serving.main(argv)
    print(f"EXPORTED {argv[argv.index('--out') + 1]} in {time.perf_counter() - t0:.1f} s",
          flush=True)
"""


CALL_CHECK = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from causaldiffae_torch import serve, serving
from causaldiffae_torch.models.attention import AttentionBlock
from causaldiffae_torch.ops import attention as ops
ckpt, out, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
cfg, model, _ = serve.load_checkpoint(ckpt, use_ema=False, device="cuda")
model.requires_grad_(False)
ops.prepare_forward("cuda")
req = serve.synthetic_requests(cfg, 16, seed)
x, y = torch.from_numpy(req["x"]).cuda(), torch.from_numpy(req["y"]).cuda()
xt = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                 device="cuda")
t = torch.full((x.shape[0],), 500, dtype=torch.long, device="cuda")
blocks = [b for b in model.modules() if isinstance(b, AttentionBlock)]


class Call(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.model = model

    def forward(self, xt, t, y, z):
        return self.model.denoise(xt, t, y=y, z=z)


with torch.inference_mode():
    z = model.encode(x)[0]
    eps = {"kernel": model.denoise(xt, t, y=y, z=z)}
    for b in blocks:
        b.use_kernels = False
    eps["plain"] = model.denoise(xt, t, y=y, z=z)
    for b in blocks:
        b.use_kernels = True
    saved = [b.proj_out.weight.clone() for b in blocks]
    for b in blocks:
        b.proj_out.weight.zero_()
    eps["no attention"] = model.denoise(xt, t, y=y, z=z)
    for b, w in zip(blocks, saved):
        b.proj_out.weight.copy_(w)
z = z.clone()
with torch.no_grad():
    ep = torch.export.export(Call(), (xt, t, y, z))
rec = serving.export_compiled_artifact(ep, out)
package = serving.load_compiled_artifact(out)
ops.attention_fwd.launches = ops.attention_fwd.lse_launches = 0
with torch.inference_mode():
    eps["AOT package"] = package(xt, t, y, z)
    torch.cuda.synchronize()
rms = {k: float((v.float() - eps["kernel"].float()).pow(2).mean().sqrt()) for k, v in eps.items()}
print("CALL " + json.dumps({"compile_s": rec["compile_s"], "launches": ops.attention_fwd.launches,
                            "lse_launches": ops.attention_fwd.lse_launches, "rms": rms,
                            "eps_rms": float(eps["kernel"].float().pow(2).mean().sqrt())}))
"""
# phase 14's bound on one UNet call of the AOT package: its eps may stand no
# farther from the eager call's (both with the kernel) than 1.5x the plain
# attention's eps does, the rounding distance of two right routes (phase 4's
# rule). Removing the attention's answer moved eps ~10x farther than the bound.
AOT_CALL_RATIO = 1.5


def start_call_check(work, ckpt):
    """Phase 14's check of the op inside an AOTInductor package, one UNet call
    of the flagship on ``ckpt`` at batch 16, in a process of its own (its
    compile takes minutes). Returns ``(process, {}, log)``."""
    d = os.path.join(work, "artifacts")
    os.makedirs(d, exist_ok=True)
    log = open(os.path.join(d, "call-check.log"), "w")
    env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS="4")
    proc = subprocess.Popen([sys.executable, "-c", CALL_CHECK, ckpt,
                             os.path.join(d, "call.pt2"), str(SEED + 3)], cwd=REPO,
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, {}, log


def filled_checkpoint(src, dst, seed):
    """A copy of the latest checkpoint in ``src`` whose raw weights are filled
    by ``fill_weights_`` (2 train steps leave every attention output
    projection near its zero init, which would hide the attention op's
    answer from a comparison). Returns ``dst``."""
    from causaldiffae_torch import serve
    from causaldiffae_torch.training import CheckpointManager
    from causaldiffae_torch.training.state import create_train_state

    cfg, model, step = serve.load_checkpoint(src, use_ema=False, device="cpu")
    fill_weights_(model, seed)
    CheckpointManager(dst, config=cfg).save(step, create_train_state(cfg, model))
    return dst


def start_exports(work, tag, jobs):
    """Phase 14's exports in a process of their own, so that they (the
    AOTInductor compile takes minutes) run beside other phases: ``jobs`` is a list of
    ``(name, checkpoint, extra argv)``, each a counterfactual at batch 16
    verified by the CLI. Returns ``(process, {name: path}, log)``."""
    d = os.path.join(work, "artifacts")
    os.makedirs(d, exist_ok=True)
    paths = {name: os.path.join(d, f"{name}.pt2") for name, _, _ in jobs}
    argvs = [["--ckpt_dir", ckpt, "--out", paths[name], "--fn", "counterfactual",
              "--batch_size", str(ARTIFACT_BATCH), *extra] for name, ckpt, extra in jobs]
    log = open(os.path.join(d, f"export-{tag}.log"), "w")
    env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS="4")   # leave the phases cores
    proc = subprocess.Popen([sys.executable, "-c", EXPORTER, json.dumps(argvs)], cwd=REPO,
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, paths, log


DPM25 = ["--sampler", "dpm++", "--sample_steps", "25"]


def artifact_phase(ops, exporters, morpho_ckpt, filled_ckpt):
    """Phase 14: serving artifacts at full width, with the kernel inside;
    ``morpho_ckpt`` is the train CLI's 2-step checkpoint, ``filled_ckpt`` its
    copy with every weight filled. Returns the forward kernel's launches by
    path."""
    from causaldiffae_torch import serve, serve_artifact, serving
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.diffusion.sampling import dpm_solver_pp_nodes
    from causaldiffae_torch.evals import make_counterfactual_fn

    t0, paths, call = time.perf_counter(), {}, None
    for proc, got, log in exporters:
        rc = proc.wait(timeout=1200)
        log.close()
        with open(log.name) as f:
            lines = f.read().splitlines()
        print(f"{time.perf_counter() - t0:.1f} s into the wait, {os.path.basename(log.name)}:")
        for ln in lines:
            if ln.startswith(("EXPORTED", "wrote", "verify", "Traceback")) or "Error" in ln:
                print("    " + ln)
            if ln.startswith("CALL "):
                call = json.loads(ln[5:])
        if rc != 0:
            raise AssertionError("the exports failed:\n" + "\n".join(lines[-40:]))
        paths.update(got)
    mans = {k: json.load(open(p + serving.MANIFEST_SUFFIX)) for k, p in paths.items()}
    out, man = paths["ddim"], mans["ddim"]
    fout, fman = paths["ddim_filled"], mans["ddim_filled"]
    atol = max(1e-5, 2e-5 * DDIM_STEPS)
    aot = man["aot"]
    # (a) what the export made
    print(f"(a) morphomnist DDIM-{DDIM_STEPS} counterfactual at batch {ARTIFACT_BATCH}: export "
          f"{man['export_s']:.1f} s, AOT compile {aot['compile_s']:.1f} s (host compiler "
          f"{aot['cxx']}, 4 compile threads beside phases 8b-11); artifact {man['bytes']} bytes, "
          f"AOT package {aot['bytes']} bytes; attention {man['attention']}, "
          f"{man['attention_nodes']} op nodes in the graph")
    print(f"    the same from the filled checkpoint, without a package: export "
          f"{fman['export_s']:.1f} s, attention {fman['attention']}, "
          f"{fman['attention_nodes']} op nodes")
    for label, m in (("2-step", man), ("filled", fman)):
        for v in m["verify"]:
            print(f"    verify {label} {v['route']}: max|direct - artifact| {v['max_abs']:.3e} "
                  f"(atol {v['atol']:.1e})")
    if any(m["attention"] != "kernel" or m["attention_nodes"] != 8 or
           any(v["max_abs"] > atol for v in m["verify"]) for m in (man, fman)) or \
            [v["route"] for v in man["verify"]] != ["artifact", "AOT package"]:
        raise AssertionError("an artifact lacks the attention op, or it or its AOT package "
                             "does not verify")
    # the op inside an AOT package, one UNet call on the filled weights
    rms = call["rms"]
    bound = AOT_CALL_RATIO * rms["plain"]
    print(f"    one UNet call's AOT package on the filled weights (compile "
          f"{call['compile_s']:.1f} s): its eps {rms['AOT package']:.3e} rms from the eager "
          f"call's (bound {bound:.3e}, {AOT_CALL_RATIO} x the plain attention's "
          f"{rms['plain']:.3e}; eps rms {call['eps_rms']:.3e}); without the attention's answer "
          f"{rms['no attention']:.3e}; {call['launches']} launches, {call['lse_launches']} "
          f"with lse")
    if call["launches"] != 8 or call["lse_launches"] or not rms["AOT package"] <= bound or \
            not rms["no attention"] > bound:
        raise AssertionError("the AOT package's UNet call does not answer as the eager one, "
                             "or the bound cannot see the attention's answer")
    # (b) three ways, and (f) their latency, beside the in-process route of phase 5
    routes = {"AOT package": served_artifact(ops, serve_artifact, out, "aot", ["--prewarm"],
                                             DDIM_STEPS, 8),
              "portable program": served_artifact(ops, serve_artifact, out, "portable",
                                                  ["--no_aot"], DDIM_STEPS, 8)}
    if routes["AOT package"]["aot"] is not True or routes["portable program"]["aot"]:
        raise AssertionError("the AOT package did not serve with --prewarm, or did with --no_aot")
    fresh = subprocess.run([sys.executable, "-c", FRESH_CONSUMER, "--artifact", out,
                            "--synthetic", str(ARTIFACT_REQUESTS), "--value", "1.0",
                            "--out", out + ".fresh.npz"], capture_output=True, text=True,
                           cwd=REPO, timeout=900)
    found = [ln for ln in fresh.stdout.splitlines() if ln.startswith("FRESH ")]
    if fresh.returncode != 0 or not found:
        raise AssertionError(f"the fresh consumer failed:\n{fresh.stdout[-2000:]}\n"
                             f"{fresh.stderr[-3000:]}")
    routes["fresh process"] = json.loads(found[0][6:])
    want = 8 * DDIM_STEPS * (ARTIFACT_REQUESTS // ARTIFACT_BATCH)
    if routes["fresh process"]["attention_launches"] != want:
        raise AssertionError(f"fresh process: {routes['fresh process']['attention_launches']} "
                             f"launches, expected {want}")
    norms_match("artifact_fresh_process", "morphomnist_causaldae", (want, 0, 0),
                (routes["fresh process"]["norm_launches"], 0))
    print(f"(b) the fresh consumer loaded no model code and served with aot "
          f"{routes['fresh process']['aot']}, {want} launches")
    cfg, model, _ = serve.load_checkpoint(morpho_ckpt, use_ema=False, device="cuda")
    requests = serve.synthetic_requests(cfg, ARTIFACT_REQUESTS, SEED)
    lat = [r["latency_s"] for r in serve.serve(cfg, model, requests, intervene_var=0,
                                                value=1.0, batch=ARTIFACT_BATCH, seed=SEED)]
    routes["in-process (phase 5)"] = {"first_call_s": lat[0],
                                      "steady_batch_s": float(np.mean(lat[1:])),
                                      "steady_batch_p50_s": float(np.median(lat[1:]))}
    # (c) the same draws through the artifacts and in-process serving
    diffusion = create_diffusion(cfg, eval_mode=True)
    x = torch.from_numpy(requests["x"][:ARTIFACT_BATCH]).cuda()
    y = torch.from_numpy(requests["y"][:ARTIFACT_BATCH]).cuda()
    rep_noise, abduction_noise = serving.draw_inputs(man, ARTIFACT_BATCH, SEED + 5, "cuda")
    filled = serve.load_checkpoint(filled_ckpt, use_ema=False, device="cuda")[1]
    deltas = {}
    for label, m, path, package in (("2-step", model, out, True),
                                    ("filled", filled, fout, False)):
        direct = make_counterfactual_fn(cfg, m, diffusion, intervene_var=0)(
            x, {"y": y}, 1.0, rep_noise=rep_noise, abduction_noise=abduction_noise)
        programs = {"portable program": serving.load_artifact(path)[0]}
        if package:
            programs["AOT package"] = serving.load_artifact(path, serving.load_compiled_artifact(
                path + serving.COMPILED_SUFFIX))[0]
        for name, fn in programs.items():
            deltas[f"{label} {name}"] = float((fn(x, y, 1.0, SEED + 5) - direct).abs().max())
    print("(c) same request and draws, max|Δ| from in-process serving: " + ", ".join(
        f"{k} {v:.3e}" for k, v in deltas.items()) + f" (atol {atol:.1e})")
    if not all(v <= atol for v in deltas.values()):
        raise AssertionError("an artifact's answer is too far from in-process serving's")
    del model, filled
    torch.cuda.empty_cache()
    # (d) DPM++-25 with a symbolic batch, served at 1 and 16
    pman = mans["poly"]
    nodes = len(dpm_solver_pp_nodes(diffusion, 2, 25)[0])
    fn = serving.load_artifact(paths["poly"])[0]
    for b in (1, ARTIFACT_BATCH):
        reset_counts(ops)
        imgs = fn(x[:b], y[:b], 1.0, SEED)
        torch.cuda.synchronize()
        if counts(ops) != (8 * nodes, 0, 0) or imgs.shape != (b, 28, 28, 1) or \
                not bool(torch.isfinite(imgs).all()):
            raise AssertionError(f"poly artifact at batch {b}: launches {counts(ops)}, shape "
                                 f"{tuple(imgs.shape)}")
        norms_match(f"artifact_poly_b{b}", "morphomnist_causaldae", counts(ops))
    print(f"(d) DPM++-25 ({nodes} UNet calls) poly-batch artifact: export {pman['export_s']:.1f} s,"
          f" verify " + ", ".join(f"batch {v['batch']} {v['max_abs']:.3e}" for v in pman["verify"])
          + f" (atol {pman['verify'][0]['atol']:.1e}); served at batch 1 and {ARTIFACT_BATCH}, "
          f"{8 * nodes} launches each")
    # (e) the pendulum (d = 128, one attention block per UNet call)
    eman = mans["pendulum"]
    pfn = serving.load_artifact(paths["pendulum"])[0]
    reset_counts(ops)
    pimgs = pfn(torch.zeros(ARTIFACT_BATCH, 96, 96, 4, device="cuda"), 1.0, SEED)
    torch.cuda.synchronize()
    if eman["attention_nodes"] != 1 or counts(ops)[1:] != (0, 0) or not counts(ops)[0] or \
            not bool(torch.isfinite(pimgs).all()):
        raise AssertionError(f"pendulum artifact: {eman['attention_nodes']} op nodes, launches "
                             f"{counts(ops)}")
    norms_match("artifact_pendulum", "pendulum_causaldae", counts(ops))
    print(f"(e) pendulum DPM++-25 artifact: export {eman['export_s']:.1f} s, verify max|Δ| "
          f"{eman['verify'][0]['max_abs']:.3e} (atol {eman['verify'][0]['atol']:.1e}), "
          f"{counts(ops)[0]} launches for one chain (1 per UNet call)")
    # (f) latency at batch 16 through DDIM-250
    print(f"(f) DDIM-{DDIM_STEPS} at batch {ARTIFACT_BATCH}, host clock: route, first_call_s, "
          f"steady_batch_s, steady_batch_p50_s")
    for name, r in routes.items():
        print(f"    {name:22s} {r['first_call_s']:8.3f} {r['steady_batch_s']:8.3f} "
              f"{r['steady_batch_p50_s']:8.3f}" + (f"  (prewarm {r['prewarm_s']:.3f} s)"
                                                   if "prewarm_s" in r else ""))
    return {"artifact_portable": routes["portable program"]["attention_launches"],
            "artifact_aot": routes["AOT package"]["attention_launches"],
            "artifact_fresh_process": routes["fresh process"]["attention_launches"]}


def dispatch_cost(ops):
    """Host microseconds per call of the forward through the dispatcher op
    and through its ctypes wrapper, at the serving shape: many calls enqueued
    back to back, timed on the host clock without waiting for the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(ARTIFACT_BATCH, 784, 384, generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for name, fn in (("wrapper", ops.attention_fwd), ("op", torch.ops.causaldiffae.attention_fwd),
                     ("op", torch.ops.causaldiffae.attention_fwd), ("wrapper", ops.attention_fwd)):
        for _ in range(20):
            fn(qkv, 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn(qkv, 4)
        out.setdefault(name, []).append((time.perf_counter() - t0) / 500 * 1e6)
        torch.cuda.synchronize()
    return out


def other_modules_phase(ops, work):
    """Phase 15: the super-resolution model, feature_vectors, the native
    loader and the adjacency validation."""
    from causaldiffae_torch import validate_adjacency
    from causaldiffae_torch.config import create_model, create_sr_model, get_config
    from causaldiffae_torch.data import batch_iterator, synthetic_dataset
    from causaldiffae_torch.data.loaders import _uint8_pool, make_data_iterator
    from causaldiffae_torch.data.native_loader import NativeBatchIterator

    cfg = get_config("morphomnist_causaldae")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sr = create_sr_model(cfg, large_size=256, small_size=64)
    fill_weights_(sr, SEED)
    n_params = sum(p.numel() for p in sr.parameters())
    x = torch.randn(4, 256, 256, 1, generator=gen, device="cuda")
    low = torch.randn(4, 64, 64, 1, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (4,), generator=gen, device="cuda")
    y = torch.arange(4, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = wall_ms(lambda: sr(x, t, low_res=low, y=y), iters=3, warmup=1)
        eps, _ = sr(x, t, low_res=low, y=y)
    if not (eps.shape == (4, 256, 256, 1) and bool(torch.isfinite(eps).all())):
        raise AssertionError("the SR model's eps is not finite or has the wrong shape")
    print(f"SR model at 256 from 64 ({n_params / 1e6:.2f} M parameters), bf16, batch 4: "
          f"{ms:.1f} ms per forward (host clock, synced), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, eps rms {rms(eps):.4f}")
    del sr, eps
    torch.cuda.empty_cache()
    model = create_model(cfg)
    fill_weights_(model, SEED)
    with torch.inference_mode():
        feats = model.feature_vectors(torch.randn(4, 28, 28, 1, generator=gen, device="cuda"),
                                      t, y=y)
    levels = len(cfg.channel_mult)
    want = (1 + levels * cfg.num_res_blocks + levels - 1, levels * (cfg.num_res_blocks + 1))
    got = (len(feats["down"]), len(feats["up"]))
    finite = all(bool(torch.isfinite(f).all()) for f in feats["down"] + feats["up"]
                 + [feats["middle"]])
    if got != want or not finite:
        raise AssertionError(f"feature_vectors: {got} down/up activations, the JAX structure has "
                             f"{want}, finite {finite}")
    print(f"feature_vectors: {got[0]} down, 1 middle, {got[1]} up activations, as the JAX "
          f"structure has; middle {tuple(feats['middle'].shape)}")
    del model, feats
    data = synthetic_dataset("morphomnist", POOL, seed=SEED)
    native = make_data_iterator(data, 128, seed=SEED)
    if not isinstance(native, NativeBatchIterator):
        raise AssertionError("the native loader did not build or serve")
    u8, scale, offset = _uint8_pool(data["image"])
    second = NativeBatchIterator(u8, 128, c=data["c"], y=data["y"], scale=scale, offset=offset,
                                 seed=SEED)
    for _ in range(20):
        a, b = next(native), next(second)
        if any(not np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError("two native loaders with the same seed gave different batches")
    rates = {}
    for name, it in (("native", native), ("numpy", batch_iterator(data, 128, seed=SEED))):
        next(it)
        t0 = time.perf_counter()
        for _ in range(200):
            next(it)
        rates[name] = 200 / (time.perf_counter() - t0)
    native.close()
    second.close()
    print(f"native loader at batch 128: route native C++ prefetch ({POOL} samples as uint8), "
          f"{rates['native']:.0f} batches/s against the numpy batch_iterator's "
          f"{rates['numpy']:.0f}; 20 batches bit-equal to a second loader from the same seed")
    out = os.path.join(work, "adjacency.json")
    res = validate_adjacency.main(["--steps", "20", "--seeds", "0", "--out", out])
    A = np.asarray(res["runs"][0]["A"])
    if set(res) != {"preset", "steps", "threshold", "truth", "runs", "pooled"} or \
            not np.isfinite(A).all() or A.shape != (2, 2):
        raise AssertionError(f"validate_adjacency: keys {sorted(res)}, A {A}")
    print(f"validate_adjacency, 20 steps, seed 0: A {A.tolist()}, pooled {res['pooled']}")


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

    phase("3c. the norm kernels against their plain versions, with their times")
    norm = norm_phase(gen)

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
    norms_match("serving", cfg.name, counts(ops))
    cost = dispatch_cost(ops)
    print(f"host us per forward call at ({ARTIFACT_BATCH}, 784, 4, 32), enqueued back to back, "
          f"in turns: ctypes wrapper {[round(c, 2) for c in cost['wrapper']]}, dispatcher op "
          f"{[round(c, 2) for c in cost['op']]}")

    phase("6. training: morphomnist_causaldae at full width")
    del model
    torch.cuda.empty_cache()
    train_launches = train_phase(cfg, ops, gen)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(REPO, "build"))
    exporters = []
    try:  # checkpoints (2.6 GB each for the circuit) and evaluation files
        from causaldiffae_torch import train

        morpho_ckpt = os.path.join(work, "morpho-ckpt")   # phases 9, 10, 13b and 14 read it
        t0 = time.perf_counter()
        train.main(["--preset", "morphomnist_causaldae", "--synthetic", "--total_steps", "2",
                    "--save_interval", "2", "--log_interval", "1", "--ckpt_dir", morpho_ckpt])
        print(f"train CLI: 2 steps and a checkpoint in {time.perf_counter() - t0:.2f} s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        filled_ckpt = filled_checkpoint(morpho_ckpt, os.path.join(work, "morpho-filled"),
                                        SEED + 2)   # read by phase 14
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
        # phases 12-16 (timed) run before phase 14's exports start, 8b-11 beside them
        phase("12. morphomnist_causaldae with the flow prior and dropout at full width")
        flow = flow_dropout_phase(ops, gen, work)
        phase("13a. the train CLI under torchrun at world size 1 against the plain CLI")
        torchrun_phase(work)
        phase("13b. data parallelism: two gloo ranks on the card against one process")
        torch.cuda.empty_cache()
        dp = data_parallel_phase(ops, work, morpho_ckpt)
        phase("16a. tensor parallelism: tp = 2 on two gloo ranks on the card, remat on")
        torch.cuda.empty_cache()
        tp = tensor_parallel_phase(ops, work, card_line)
        phase("16b. remat: one step with and without use_remat, in turns")
        remat_phase(work, card_line)
        exporters.append(start_exports(work, "morphomnist", [
            ("ddim", morpho_ckpt, ["--intervene_var", "0", "--aot"])]))
        exporters.append(start_exports(work, "filled-and-pendulum", [
            ("ddim_filled", filled_ckpt, ["--intervene_var", "0"]),
            ("poly", filled_ckpt, ["--intervene_var", "0", "--poly_batch", *DPM25]),
            ("pendulum", pendulum_ckpt, ["--intervene_var", "2", *DPM25])]))
        exporters.append(start_call_check(work, filled_ckpt))
        phase("8b. repeatability: train, serve and the probes twice, bit for bit")
        repeatability_phase(work)
        phase("9. morphomnist_causaldae: effectiveness MAE, FID and the rescore")
        print("on the 2-step checkpoint the train CLI wrote after phase 6")
        evaluation = evaluation_phase("morphomnist_causaldae", ops, morpho_ckpt,
                                      os.path.join(work, "morpho-eval"), num_samples=32,
                                      sampler=None, sample_steps=None, compute_fid=True)
        phase("10. morphomnist_causaldae: the NLL sweep and prior samples")
        nll_paths = nll_and_sampling_phase(ops, gen, morpho_ckpt, work)
        phase("11. pendulum_causaldae: effectiveness MAE on phase 8's checkpoint")
        evaluation_pendulum = evaluation_phase(
            "pendulum_causaldae", ops, pendulum_ckpt, os.path.join(work, "pendulum-eval"),
            num_samples=16, sampler="dpm++", sample_steps=25, compute_fid=False)
        phase("14. serving artifacts at full width, with the kernel inside")
        torch.cuda.empty_cache()
        artifacts = artifact_phase(ops, exporters, morpho_ckpt, filled_ckpt)
        phase("15. the SR model, feature_vectors, the native loader, validate_adjacency")
        other_modules_phase(ops, work)
        phase()
    finally:
        for proc, _, _ in exporters:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
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
                "evaluation_pendulum": evaluation_pendulum,
                "training_flow_dropout": flow["attention_fwd"],
                "training_dp_rank0": dp["training_dp"][0],
                "evaluation_dp_rank0": dp["evaluation_dp"][0], "training_tp_rank0": tp[0],
                **artifacts}),
        record("attention_bwd", "causaldiffae_tpu/ops/attention_pallas.py:184 "
               "(_attn_bwd_kernel) and :308 (_attn_bwd_kernel_t)", bwd_recs,
               {"training": train_launches["attention_bwd"],
                "training_circuit": circuit["training"][2],
                "training_pendulum": pendulum["training"][2],
                "training_flow_dropout": flow["attention_bwd"],
                "training_dp_rank0": dp["training_dp"][2], "training_tp_rank0": tp[2]}),
    ]
    for i, (name, keys) in enumerate((
            ("norm_act_fwd", ("fwd_ms", "fwd_stats_ms", "fwd_bound_ms", "eager_fwd_ms",
                              "library_fwd_ms")),
            ("norm_act_bwd", ("bwd_ms", "bwd_bound_ms", "eager_bwd_ms", "library_bwd_ms")))):
        by_path = {path: n[i] for path, n in NORM_BY_PATH.items() if n[i]}
        kernels.append({
            "name": name, "route": "cuda", "source": "causaldiffae_torch/csrc/norm_act.cu",
            "replaces": "the eager GroupNorm32 chain (XLA fused it on the TPU; no Pallas kernel)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shapes": [{k: r[k] for k in ("shape", "dtype", "plan", *keys)} for r in norm["fwd"]],
            "ptxas": [r for r in norm["ptxas"] if name in r["name"]],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    if NORM_FAULTS:
        raise AssertionError("norm launches broke the rule on " + "; ".join(NORM_FAULTS))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
