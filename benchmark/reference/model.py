"""Plain PyTorch reference of the CausalDiffAE model: UNet, encoder and SCM.

Written from the published model (the reference repository's
``improved_diffusion/unet.py`` and ``nn.py``, as ``SURVEY.md`` describes
them), in float32 with plain torch operations, as functions of a dict of
tensors under the reference's ``state_dict`` key names. It imports nothing
of the measured program, so it can judge it.

``cast`` is applied to every operand of a product (convolution, dense layer,
attention) at the points where the configuration computes in its compute
dtype. The identity gives the float32 reference; :func:`fp8_cast` gives the
control, the same model one precision below bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]

CHANNEL_MULT = {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 2, 4, 4), 96: (1, 2, 3, 4),
                64: (1, 2, 3, 4), 32: (1, 2, 2, 2), 28: (1, 2, 2)}
ENCODER_DIMS = {4: (16, 32, 32, 64, 64, 128), 2: (16, 32, 64, 128)}
NUM_CLASSES = 10
GROUPS = 32
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to the format's largest), back in float32; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def bf16_cast(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in float32 (a check of the harness, not the control)."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())



# --------------------------------------------------------------------- #
# The layout: one list of layers per UNet stage, and the parameter shapes.
# --------------------------------------------------------------------- #
def attention_ds(m: dict) -> Tuple[int, ...]:
    return tuple(m["image_size"] // int(r) for r in m["attention_resolutions"].split(","))


def unet_plan(m: dict):
    """(input stages, middle, output stages); each stage a list of layers
    ``(kind, prefix, channels in, channels out)``, kind one of conv, res,
    attn, down, up."""
    mc, mult = m["num_channels"], CHANNEL_MULT[m["image_size"]]
    ds_attn = attention_ds(m)
    inputs = [[("conv", "input_blocks.0.0", m["in_channels"], mc)]]
    chans, ch, ds = [mc], mc, 1
    for level, k in enumerate(mult):
        for _ in range(m["num_res_blocks"]):
            p = f"input_blocks.{len(inputs)}"
            stage = [("res", f"{p}.0", ch, k * mc)]
            ch = k * mc
            if ds in ds_attn:
                stage.append(("attn", f"{p}.1", ch, ch))
            inputs.append(stage)
            chans.append(ch)
        if level != len(mult) - 1:
            inputs.append([("down", f"input_blocks.{len(inputs)}.0", ch, ch)])
            chans.append(ch)
            ds *= 2
    middle = [("res", "middle_block.0", ch, ch), ("attn", "middle_block.1", ch, ch),
              ("res", "middle_block.2", ch, ch)]
    outputs = []
    for level, k in list(enumerate(mult))[::-1]:
        for i in range(m["num_res_blocks"] + 1):
            p = f"output_blocks.{len(outputs)}"
            stage = [("res", f"{p}.0", ch + chans.pop(), k * mc)]
            ch = k * mc
            if ds in ds_attn:
                stage.append(("attn", f"{p}.1", ch, ch))
            if level and i == m["num_res_blocks"]:
                stage.append(("up", f"{p}.{len(stage)}", ch, ch))
                ds //= 2
            outputs.append(stage)
    return inputs, middle, outputs


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model ``m`` (a configuration's ``model`` dict)
    by its reference key, in a fixed order."""
    mc = m["num_channels"]
    ted = 4 * mc
    s: Dict[str, Tuple[int, ...]] = {}

    def lin(p, i, o):
        s[f"{p}.weight"], s[f"{p}.bias"] = (o, i), (o,)

    def conv(p, i, o, k=3):
        s[f"{p}.weight"], s[f"{p}.bias"] = (o, i, k, k), (o,)

    def norm(p, c):
        s[f"{p}.weight"], s[f"{p}.bias"] = (c,), (c,)

    lin("time_embed.0", mc, ted)
    lin("time_embed.2", ted, ted)
    if m["class_cond"]:
        s["label_emb.weight"] = (NUM_CLASSES, ted)
    if m["rep_cond"]:
        ch, size = m["in_channels"], m["image_size"]
        for i, h in enumerate(ENCODER_DIMS[m["n_vars"]]):
            conv(f"rep_emb.encoder.{i}.0", ch, h)
            norm(f"rep_emb.encoder.{i}.1", h)
            ch, size = h, (size + 1) // 2
        lin("rep_emb.fc_mu", ch * size * size, m["rep_dim"])
        lin("rep_emb.fc_var", ch * size * size, m["rep_dim"])
        lin("up_emb", m["rep_dim"], ted)
    if m["causal_modeling"]:
        d = m["rep_dim"] // m["n_vars"]
        for i in range(m["n_vars"]):
            lin(f"causal_mask.nonlinearities.{i}.net.0", d, m["rep_dim"])
            lin(f"causal_mask.nonlinearities.{i}.net.2", m["rep_dim"], d)
    inputs, middle, outputs = unet_plan(m)
    for kind, p, ci, co in [layer for stage in inputs + [middle] + outputs for layer in stage]:
        if kind == "conv":
            conv(p, ci, co)
        elif kind == "res":
            norm(f"{p}.in_layers.0", ci)
            conv(f"{p}.in_layers.2", ci, co)
            lin(f"{p}.emb_layers.1", ted, 2 * co)
            norm(f"{p}.out_layers.0", co)
            conv(f"{p}.out_layers.3", co, co)
            if ci != co:
                conv(f"{p}.skip_connection", ci, co, 1)
        elif kind == "attn":
            norm(f"{p}.norm", ci)
            s[f"{p}.qkv.weight"], s[f"{p}.qkv.bias"] = (3 * ci, ci, 1), (3 * ci,)
            s[f"{p}.proj_out.weight"], s[f"{p}.proj_out.bias"] = (ci, ci, 1), (ci,)
        elif kind == "down":
            conv(f"{p}.op", ci, co)
        else:
            conv(f"{p}.conv", ci, co)
    norm("out.0", mc)
    conv("out.2", mc, m["in_channels"])
    return s


def is_norm_scale(name: str, shape) -> bool:
    """A GroupNorm or BatchNorm scale: drawn around 1, not 0."""
    norm = (".in_layers.0.", ".out_layers.0.", ".norm.", "out.0.")
    return name.endswith(".weight") and len(shape) == 1 and (
        any(k in name for k in norm) or name.startswith("out.0") or
        (name.startswith("rep_emb.encoder.") and name.split(".")[3] == "1"))


def buffers(m: dict, device) -> Params:
    """The encoder's BatchNorm statistics as a fresh model holds them."""
    out: Params = {}
    if m["rep_cond"]:
        for i, h in enumerate(ENCODER_DIMS[m["n_vars"]]):
            p = f"rep_emb.encoder.{i}.1"
            out[f"{p}.running_mean"] = torch.zeros(h, device=device)
            out[f"{p}.running_var"] = torch.ones(h, device=device)
            out[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return out


def make_weights(m: dict, seed: int, device, std: float = 0.02) -> Params:
    """Every parameter drawn N(0, std^2) (norm scales N(1, std^2)) from
    ``seed`` in one call on ``device``, float32, as views of one buffer."""
    shapes = param_shapes(m)
    sizes = [math.prod(v) for v in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(std)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        t = part.view(shape)
        if is_norm_scale(name, shape):
            t.add_(1.0)
        out[name] = t
    return out


# --------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------- #
def _conv(P, p, x, cast, stride=1):
    w = P[f"{p}.weight"]
    return F.conv2d(cast(x), cast(w), cast(P[f"{p}.bias"]), stride, w.shape[-1] // 2)


def _lin(P, p, x, cast=identity):
    return F.linear(cast(x), cast(P[f"{p}.weight"]), cast(P[f"{p}.bias"]))


def _gn(P, p, x):
    return F.group_norm(x, GROUPS, P[f"{p}.weight"], P[f"{p}.bias"], 1e-5)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def res_block(P, p, x, emb, cast):
    h = _conv(P, f"{p}.in_layers.2", F.silu(_gn(P, f"{p}.in_layers.0", x)), cast)
    scale, shift = _lin(P, f"{p}.emb_layers.1", F.silu(emb), cast).chunk(2, dim=-1)
    h = _gn(P, f"{p}.out_layers.0", h) * (1 + scale[..., None, None]) + shift[..., None, None]
    h = _conv(P, f"{p}.out_layers.3", F.silu(h), cast)
    skip = _conv(P, f"{p}.skip_connection", x, cast) if f"{p}.skip_connection.weight" in P else x
    return skip + h


def attention_block(P, p, x, heads, cast):
    """softmax(q k^T / sqrt(d)) v over the positions, heads taken from the
    projection's channels head-major with [q, k, v] inside each head."""
    B, C = x.shape[:2]
    tokens = x.reshape(B, C, -1)
    n = _gn(P, f"{p}.norm", tokens).transpose(1, 2)
    qkv = F.linear(cast(n), cast(P[f"{p}.qkv.weight"][:, :, 0]), cast(P[f"{p}.qkv.bias"]))
    T, d = qkv.shape[1], C // heads
    q, k, v = qkv.reshape(B, T, heads, 3 * d).split(d, dim=-1)
    s = d ** -0.25
    w = torch.softmax(torch.einsum("bthd,bshd->bhts", cast(q * s), cast(k * s)), dim=-1)
    h = torch.einsum("bhts,bshd->bthd", cast(w), cast(v)).reshape(B, T, C)
    h = F.linear(cast(h), cast(P[f"{p}.proj_out.weight"][:, :, 0]), cast(P[f"{p}.proj_out.bias"]))
    return (tokens + h.transpose(1, 2)).reshape(x.shape)


def _layer(P, layer, h, emb, heads, cast):
    kind, p, _, _ = layer
    if kind == "conv":
        return _conv(P, p, h, cast)
    if kind == "res":
        return res_block(P, p, h, emb, cast)
    if kind == "attn":
        return attention_block(P, p, h, heads, cast)
    if kind == "down":
        return _conv(P, f"{p}.op", h, cast, stride=2)
    return _conv(P, f"{p}.conv", F.interpolate(h, scale_factor=2, mode="nearest"), cast)


def unet(P: Params, m: dict, x: torch.Tensor, t: torch.Tensor, y=None, z=None,
         cast: Cast = identity, layer_hook=None) -> torch.Tensor:
    """eps for NHWC ``x`` at model timesteps ``t``, conditioned on class
    ``y`` and representation ``z``. ``layer_hook(fn, *args)`` may wrap each
    block's call (the harness passes activation checkpointing to hold the
    memory of a full-width training step)."""
    mc = m["num_channels"]
    emb = _lin(P, "time_embed.2", F.silu(_lin(P, "time_embed.0", timestep_embedding(t, mc))))
    if m["class_cond"]:
        emb = emb + P["label_emb.weight"][y]
    if z is not None:
        emb = emb + _lin(P, "up_emb", z)
    heads = m["num_heads"]
    run = layer_hook or (lambda fn, *a: fn(*a))

    def stage(layers, h):
        for layer in layers:
            h = run(lambda hh, ee, layer=layer: _layer(P, layer, hh, ee, heads, cast), h, emb)
        return h

    inputs, middle, outputs = unet_plan(m)
    h, hs = x.permute(0, 3, 1, 2), []
    for layers in inputs:
        h = stage(layers, h)
        hs.append(h)
    h = stage(middle, h)
    for layers in outputs:
        h = stage(layers, torch.cat([h, hs.pop()], dim=1))
    h = F.silu(_gn(P, "out.0", h))
    return _conv(P, "out.2", h, identity).permute(0, 2, 3, 1)


# --------------------------------------------------------------------- #
# Encoder and SCM
# --------------------------------------------------------------------- #
def encode(P: Params, m: dict, x: torch.Tensor, train: bool, cast: Cast = identity):
    """q(u | x) of NHWC images: (mu, var). In training BatchNorm normalises
    with the batch's statistics (biased variance) and updates the running
    ones in place with momentum 0.1; else it uses the running ones."""
    h = x.permute(0, 3, 1, 2)
    for i in range(len(ENCODER_DIMS[m["n_vars"]])):
        p = f"rep_emb.encoder.{i}"
        h = _conv(P, f"{p}.0", h, cast, stride=2)
        mean_r, var_r = P[f"{p}.1.running_mean"], P[f"{p}.1.running_var"]
        if train:
            mean = h.mean(dim=(0, 2, 3))
            var = h.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                mean_r.mul_(0.9).add_(0.1 * mean)
                var_r.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = mean_r, var_r
        h = (h - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + 1e-5)
        h = h * P[f"{p}.1.weight"][:, None, None] + P[f"{p}.1.bias"][:, None, None]
        h = F.leaky_relu(h, 0.01)
    h = h.flatten(1)
    return _lin(P, "rep_emb.fc_mu", h), F.softplus(_lin(P, "rep_emb.fc_var", h)) + 1e-8


def causalize(P: Params, m: dict, u: torch.Tensor, adjacency: List[List[float]]) -> torch.Tensor:
    """z_post_i = g_i(sum_j A[j, i] u_j) + u_i over the variables' blocks."""
    n = m["n_vars"]
    ub = u.reshape(u.shape[0], n, -1)
    A = torch.tensor(adjacency, dtype=u.dtype, device=u.device)
    z_pre = torch.einsum("ji,bjd->bid", A, ub)
    out = []
    for i in range(n):
        p = f"causal_mask.nonlinearities.{i}.net"
        out.append(_lin(P, f"{p}.2", F.leaky_relu(_lin(P, f"{p}.0", z_pre[:, i]), 0.01))
                   + ub[:, i])
    return torch.stack(out, dim=1).reshape(u.shape)

