"""Operations and bytes from shapes, and the H100's peaks.

Model FLOPs count the products of a forward pass, 2 per multiply-add: every
convolution and dense layer of the UNet, the encoder and the SCM, and the
attention's projections and its two T x T products. Elementwise work (norms,
activations, softmax) is not counted. A train step counts three forwards
(forward, and the backward's two products per layer), not the kernels'
recomputation. The attention bound is ``chip_smoke.py``'s arithmetic, frozen
here: the largest of the bytes at the HBM rate (each input read once, each
output written once, bf16), the T x T products at the bf16 tensor-core peak,
and the softmax's fp32 operations at the fp32 peak. The shapes come from the
configuration, so the counts stay whatever implements the layers.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference.model import ENCODER_DIMS, unet_plan

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

Shape = Tuple[int, int, int, int]   # (B, T, H, d)


def _conv(hw: int, ci: int, co: int, k: int = 3) -> int:
    return 2 * hw * ci * co * k * k


def unet_forward_flops(m: dict) -> int:
    """FLOPs of one UNet forward of one image, conditioning included."""
    mc, size = m["num_channels"], m["image_size"]
    ted = 4 * mc
    flops = 2 * (mc * ted + ted * ted)                       # time_embed
    if m["rep_cond"]:
        flops += 2 * m["rep_dim"] * ted                      # up_emb
    inputs, middle, outputs = unet_plan(m)
    side = size
    for stage in inputs + [middle] + outputs:
        for kind, _, ci, co in stage:
            hw = side * side
            if kind == "conv":
                flops += _conv(hw, ci, co)
            elif kind == "res":
                flops += _conv(hw, ci, co) + _conv(hw, co, co) + 2 * ted * 2 * co
                if ci != co:
                    flops += _conv(hw, ci, co, 1)
            elif kind == "attn":
                flops += 2 * hw * ci * 3 * ci + 4 * hw * hw * ci + 2 * hw * ci * ci
            elif kind == "down":
                side //= 2
                flops += _conv(side * side, ci, co)
            else:
                side *= 2
                flops += _conv(side * side, ci, co)
    flops += _conv(size * size, mc, m["in_channels"])       # out.2
    return flops


def encoder_flops(m: dict) -> int:
    """FLOPs of the encoder and the SCM layer for one image."""
    if not m["rep_cond"]:
        return 0
    flops, ch, side = 0, m["in_channels"], m["image_size"]
    for h in ENCODER_DIMS[m["n_vars"]]:
        side = (side + 1) // 2
        flops += _conv(side * side, ch, h)
        ch = h
    flops += 2 * 2 * ch * side * side * m["rep_dim"]        # fc_mu, fc_var
    if m["causal_modeling"]:
        n, d = m["n_vars"], m["rep_dim"] // m["n_vars"]
        flops += 2 * n * n * d + n * 2 * 2 * d * m["rep_dim"]   # A^T u, the MLPs
    return flops


def train_step_flops(m: dict, batch: int) -> int:
    return 3 * batch * (unet_forward_flops(m) + encoder_flops(m))


def request_flops(m: dict, batch: int, unet_calls: int) -> int:
    """A counterfactual request: the encoder and SCM once, the UNet per call."""
    return batch * (encoder_flops(m) + unet_calls * unet_forward_flops(m))


def attention_shapes(m: dict, batch: int) -> List[Shape]:
    """(B, T, H, d) of each attention launch of one UNet forward."""
    out, side = [], m["image_size"]
    inputs, middle, outputs = unet_plan(m)
    for stage in inputs + [middle] + outputs:
        for kind, _, ci, _ in stage:
            if kind == "attn":
                out.append((batch, side * side, m["num_heads"], ci // m["num_heads"]))
            elif kind == "down":
                side //= 2
            elif kind == "up":
                side *= 2
    return out


def attention_fwd_bound_s(B: int, T: int, H: int, d: int) -> float:
    C = H * d
    bytes_s = 2 * (B * T * 3 * C + B * T * C) / PEAK_BYTES
    mma_s = 4 * B * H * T * T * d / PEAK_BF16_FLOPS
    fp32_s = (4 * B * H * T * T + B * T * C) / PEAK_FP32_FLOPS
    return max(bytes_s, mma_s, fp32_s)


def attention_bwd_bound_s(B: int, T: int, H: int, d: int) -> float:
    """qkv and g read and dqkv written once; five T x T products (s again,
    dv, dp, dq, dk); five fp32 operations per score."""
    C = H * d
    bytes_s = 2 * (B * T * 3 * C + B * T * C + B * T * 3 * C) / PEAK_BYTES
    mma_s = 10 * B * H * T * T * d / PEAK_BF16_FLOPS
    fp32_s = 5 * B * H * T * T / PEAK_FP32_FLOPS
    return max(bytes_s, mma_s, fp32_s)


def attention_bound_s(m: dict, batch: int, backward: bool) -> float:
    """The least time of one UNet forward's attention launches (and, for a
    train step, their backward)."""
    total = 0.0
    for s in attention_shapes(m, batch):
        total += attention_fwd_bound_s(*s) + (attention_bwd_bound_s(*s) if backward else 0.0)
    return total


__all__ = ["PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_BYTES", "unet_forward_flops",
           "encoder_flops", "train_step_flops", "request_flops", "attention_shapes",
           "attention_fwd_bound_s", "attention_bwd_bound_s", "attention_bound_s"]
