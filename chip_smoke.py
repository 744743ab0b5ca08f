#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path, counterfactual serving on the full-width
``morphomnist_causaldae`` preset, through the hand-written attention kernel,
and fails loudly. Needs a CUDA device and the CUDA toolkit (nvcc); imports
nothing of JAX or of the JAX package. Phases:

1. environment: card name and power limit, torch and CUDA versions; TF32 off
   for matrix products and convolutions, so that the fp32 plain versions
   are full fp32;
2. build every kernel from ``causaldiffae_torch/csrc`` with nvcc (sm_90a);
3. each kernel against its plain PyTorch version at the main path's shapes
   (and a tail and a d=128 case), with times of the kernel, the plain
   version and the one-call library yardstick, beside the least time the
   card could take;
4. one full-width ``denoise`` with the kernel, with the plain attention and
   with fp64 attention, on the same random weights: the kernel's eps may
   stand at most 1.5x as far from the fp64 one as the plain version's; the
   qkv each attention block hands the kernel there is held against the
   plain version too, with the softmax's sharpness printed;
5. serving: 2 batches of 16 counterfactual requests through DDIM-250 and 1
   through DPM++-25, with every kernel's launch count reset before and read
   after, latency per batch, images per second and peak memory.

Prints the card line and one ``{"kernels": [...]}`` JSON line, and as its
last line ``{"ok": true, "device": {...}}``. Any failed check raises.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

ATTN_SHAPES = [  # (B, T, heads, d): the main path's two shapes first
    (16, 784, 4, 32),   # the seven ds=1 blocks
    (16, 49, 4, 64),    # the middle block
    (3, 100, 2, 64),    # query and key tails
    (2, 77, 2, 128),    # the other presets' head width
]
# kernel vs plain: both round p and the output to bf16, at different points,
# so they may differ by two bf16 ulps (2^-6) of sum_j p_j |v_j|, the
# magnitude of the terms each output sums (ops.attention.rounding_scale);
# the absolute floor covers the fp32 sums' order
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
    want = ops.attention_plain(qkv, H)
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
        "plain_ms": time_ms(lambda: ops.attention_plain(qkv, H), iters=5),
        "library_ms": time_ms(sdpa),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(f"attention {rec['shape']}: max_abs_err {max_abs_err:.3e} "
          f"(bound {ATTN_ATOL} + {ATTN_RTOL}*sum p|v|, max err / sum p|v| {max_rel:.3e}, "
          f"output rms {want_rms:.3e}; "
          f"sdpa vs plain {sdpa_err:.3e}), kernel_ms {rec['ms']:.4f}, "
          f"plain_ms {rec['plain_ms']:.4f}, library_ms {rec['library_ms']:.4f}, "
          f"bound_us {1e3 * bound_ms:.2f} ({bound_by}), "
          f"exp_unit_us {1e6 * B * H * T * T / PEAK_EXP:.2f}", flush=True)
    return rec


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
    seconds, log = _build.build("attention_fwd")
    print(f"nvcc csrc/attention_fwd.cu: {seconds:.2f} s")
    print(log.strip())

    phase("3. kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn_recs = [check_attention(ops, *shape, gen) for shape in ATTN_SHAPES]

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
    ops.attention_fwd.launches = 0  # the main path's count starts here
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

    main_rec = attn_recs[0]
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "causaldiffae_torch/csrc/attention_fwd.cu",
        "replaces": "causaldiffae_tpu/ops/attention_pallas.py:116 (_attn_kernel) and "
                    ":280 (_attn_kernel_t)",
        "launches": launches["attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_recs),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "shape": main_rec["shape"],
        "other_shapes": attn_recs[1:],
    }]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
