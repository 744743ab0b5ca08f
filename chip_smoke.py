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
   one nvcc per source, all started together;
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
   with its times, SDPA's backward time (forward + backward minus forward)
   and its bound;
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
   and DPM++-25, 1 launch of each kind per step and 1 per UNet call.

Prints the card line and one ``{"kernels": [...]}`` JSON line, and as its
last line ``{"ok": true, "device": {...}}``. Any failed check raises.

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
]
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


def phase(name):
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
    rec = {
        "shape": [B, T, H, d],
        "max_abs_err": float(err.max()),
        "ms": time_ms(lambda: ops.attention_bwd(qkv, g, H, out, lse)),
        "plain_ms": time_ms(lambda: ops.attention_bwd_plain(qkv, g, H), iters=3),
        "library_ms": max(time_ms(sdpa_both) - time_ms(sdpa_fwd), 0.0),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(f"attention backward {rec['shape']}: max_abs_err {rec['max_abs_err']:.3e} (bound "
          f"{ATTN_ATOL} + {ATTN_RTOL}*M, max err / M {float((err / scale).max()):.3e}, "
          f"gradient rms {rms(want):.3e}); RMS from fp64 on {n} batch elements: kernel "
          f"{d_kernel:.3e}, plain {d_plain:.3e}; kernel_ms {rec['ms']:.4f}, plain_ms "
          f"{rec['plain_ms']:.4f} (at B={B}), library_ms (SDPA fwd+bwd minus fwd) "
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


def cli_phase(name, ops, gen, *, steps, save_interval, sampler, sample_steps, intervene_var):
    """Phases 7 and 8 on preset ``name`` at full width: the gradient check,
    then the train CLI's ``main`` to step ``steps[0]`` and again to
    ``steps[1]`` (it must resume), then the serve CLI's ``main`` from the
    checkpoint. Returns the kernels' launch counts by path."""
    from causaldiffae_torch import serve, train
    from causaldiffae_torch.config import get_config
    from causaldiffae_torch.training import CheckpointManager

    cfg = get_config(name)
    n = ATTN_PER_CALL[name]
    gradient_check(cfg, ops, gen, SEED + 4)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix=f"smoke-{name}-", dir=os.path.join(REPO, "build"))
    ckpt, logdir = os.path.join(work, "ckpt"), os.path.join(work, "log")
    args = ["--preset", name, "--synthetic", "--save_interval", str(save_interval),
            "--log_interval", "1", "--ckpt_dir", ckpt, "--logdir", logdir]
    try:
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"training": train_counts, "serving": fwd}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card")
    sys.path.insert(0, REPO)
    from causaldiffae_torch import serve
    from causaldiffae_torch.config import create_model, get_config
    from causaldiffae_torch.ops import _build
    from causaldiffae_torch.ops import attention as ops

    t_start = time.perf_counter()
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
    sources = ("attention_fwd", "attention_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        builds = list(pool.map(_build.build, sources))
    for name, (seconds, log) in zip(sources, builds):
        print(f"nvcc csrc/{name}.cu: {seconds:.2f} s")
        print(log.strip())

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

    phase("7. circuit_causaldae at full width: train, checkpoint, resume, serve")
    circuit = cli_phase("circuit_causaldae", ops, gen, steps=(4, 6), save_interval=2,
                        sampler="ddim", sample_steps=None, intervene_var=0)
    phase("8. pendulum_causaldae at full width: train, checkpoint, resume, serve")
    pendulum = cli_phase("pendulum_causaldae", ops, gen, steps=(2, 4), save_interval=2,
                         sampler="dpm++", sample_steps=25, intervene_var=2)

    def record(name, replaces, recs, launches_by_path):
        main_rec = recs[0]
        return {
            "name": name, "route": "cuda", "source": f"causaldiffae_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **{k: main_rec[k] for k in ("ms", "ms_with_lse", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "shape") if k in main_rec},
            "other_shapes": recs[1:],
        }

    kernels = [
        record("attention_fwd", "causaldiffae_tpu/ops/attention_pallas.py:116 (_attn_kernel) "
               "and :280 (_attn_kernel_t)", attn_recs,
               {"serving": launches["attention_fwd"], "training": train_launches["attention_fwd"],
                "serving_circuit": circuit["serving"], "training_circuit": circuit["training"][0],
                "serving_pendulum": pendulum["serving"],
                "training_pendulum": pendulum["training"][0]}),
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
