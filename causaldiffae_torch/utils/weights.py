"""Carry weights into the port.

:func:`state_dict_from_flax` takes the JAX package's flax variables
(``{"params", "batch_stats"}`` as nested dicts of numpy arrays) and returns
the port's ``state_dict`` under the reference torch keys. It is the port's
own copy of the export walk in ``causaldiffae_tpu/utils/torch_port.py``
(``_unet_walk`` at ``:102-140``, ``export_torch_state_dict`` at
``:282-411``) and imports none of it. A reference ``.pt`` needs no
conversion: it loads into the port directly. Under tensor parallelism the
result is the whole model's state; ``parallel.partition.shard_state_dict``
cuts it to a rank's shard.

Layouts: Linear (in, out) -> (out, in); Conv2d (kh, kw, in, out) ->
(out, in, kh, kw); the attention's qkv/proj_out dense -> Conv1d (out, in, 1);
the encoder heads read the flattened trunk output, HWC-major in flax and
C-major here, so their weights' input dimension is permuted; the stacked
per-variable SCM weights (n, in, out) split into n Linear layers; the flow
prior's conditioners ``{s,t}_cond.Dense_{0,1,2}`` become
``causal_flow.{s,t}_cond.{0,2,4}``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "classifier_state_dict_from_flax", "unet_walk",
           "flatten_variables",
           "unflatten_variables", "load_weights", "fill_normal_"]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["kernel"]).T
    out[f"{prefix}.bias"] = _np(p["bias"])


def _conv2d(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
    out[f"{prefix}.bias"] = _np(p["bias"])


def _conv1d_from_dense(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["kernel"]).T[:, :, None]
    out[f"{prefix}.bias"] = _np(p["bias"])


def _norm(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _flatten_perm_linear(out, prefix, p, channels, spatial):
    """HWC-major flatten (flax) -> C-major flatten (torch)."""
    w = _np(p["kernel"]).T                                    # (out, H*W*C)
    out_dim = w.shape[0]
    w = w.reshape(out_dim, spatial, spatial, channels)        # (out, H, W, C)
    out[f"{prefix}.weight"] = w.transpose(0, 3, 1, 2).reshape(out_dim, -1)
    out[f"{prefix}.bias"] = _np(p["bias"])


def _resblock(out, prefix, p):
    _norm(out, f"{prefix}.in_layers.0", p["GroupNorm32_0"])
    _conv2d(out, f"{prefix}.in_layers.2", p["Conv3x3_0"]["Conv_0"])
    _linear(out, f"{prefix}.emb_layers.1", p["DenseT_0"]["Dense_0"])
    _norm(out, f"{prefix}.out_layers.0", p["GroupNorm32_1"])
    _conv2d(out, f"{prefix}.out_layers.3", p["Conv3x3_1"]["Conv_0"])
    for skip in ("Conv1x1_0", "Conv3x3_2"):
        if skip in p:
            _conv2d(out, f"{prefix}.skip_connection", p[skip]["Conv_0"])


def _attention(out, prefix, p):
    _norm(out, f"{prefix}.norm", p["GroupNorm32_0"])
    _conv1d_from_dense(out, f"{prefix}.qkv", p["DenseT_0"]["Dense_0"])
    _conv1d_from_dense(out, f"{prefix}.proj_out", p["DenseT_1"]["Dense_0"])


def unet_walk(cfg):
    """Yield ``(flax_prefix, torch_prefix, kinds)`` over the UNet stacks.

    The block topology of ``CausalUNet``: input/middle/output stacks and the
    ``ds`` bookkeeping that places attention, down- and upsampling.
    """
    attention_ds = cfg.attention_ds
    channel_mult = cfg.channel_mult

    yield "input_blocks_0", "input_blocks.0", ["conv"]
    idx = 1
    ds = 1
    for level in range(len(channel_mult)):
        for _ in range(cfg.num_res_blocks):
            kinds = ["res"] + (["attn"] if ds in attention_ds else [])
            yield f"input_blocks_{idx}", f"input_blocks.{idx}", kinds
            idx += 1
        if level != len(channel_mult) - 1:
            yield f"input_blocks_{idx}", f"input_blocks.{idx}", ["down"]
            idx += 1
            ds *= 2

    yield "middle_blocks", "middle_block", ["res", "attn", "res"]

    idx = 0
    for level in range(len(channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            kinds = ["res"]
            if ds in attention_ds:
                kinds.append("attn")
            if level and i == cfg.num_res_blocks:
                kinds.append("up")
                ds //= 2
            yield f"output_blocks_{idx}", f"output_blocks.{idx}", kinds
            idx += 1


def state_dict_from_flax(cfg, variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (reference keys) from flax variables.

    BatchNorm ``num_batches_tracked`` counters have no flax counterpart and
    are emitted as 0 (torch reads them only under ``momentum=None``). A
    super-resolution model's flax tree holds its UNet under ``unet``; its
    keys carry no prefix here (``SuperResUNet`` is a ``CausalUNet``), and
    ``cfg`` is then the UNet's: ``image_size`` the large size.
    """
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    if "unet" in params:
        return state_dict_from_flax(cfg, {"params": params["unet"],
                                          "batch_stats": batch_stats.get("unet", {})})
    sd: Dict[str, np.ndarray] = {}

    _linear(sd, "time_embed.0", params["time_dense1"]["Dense_0"])
    _linear(sd, "time_embed.2", params["time_dense2"]["Dense_0"])
    if "label_emb" in params:
        sd["label_emb.weight"] = _np(params["label_emb"]["embedding"])
    if "c_dense1" in params:
        _linear(sd, "c_emb.0", params["c_dense1"]["Dense_0"])
        _linear(sd, "c_emb.2", params["c_dense2"]["Dense_0"])

    if "rep_emb" in params:
        ch = _conv_trunk(sd, "rep_emb.encoder", params["rep_emb"]["trunk"],
                         batch_stats["rep_emb"]["trunk"])
        flat = _np(params["rep_emb"]["fc_mu"]["Dense_0"]["kernel"]).shape[0]
        spatial = int(round((flat // ch) ** 0.5))
        _flatten_perm_linear(sd, "rep_emb.fc_mu", params["rep_emb"]["fc_mu"]["Dense_0"],
                             ch, spatial)
        _flatten_perm_linear(sd, "rep_emb.fc_var", params["rep_emb"]["fc_var"]["Dense_0"],
                             ch, spatial)
        _linear(sd, "up_emb", params["up_emb"]["Dense_0"])

    if "causal_mask" in params:
        nl = params["causal_mask"]["nonlinearities"]
        for i in range(cfg.n_vars):
            sd[f"causal_mask.nonlinearities.{i}.net.0.weight"] = _np(nl["w1"][i]).T
            sd[f"causal_mask.nonlinearities.{i}.net.0.bias"] = _np(nl["b1"][i])
            sd[f"causal_mask.nonlinearities.{i}.net.2.weight"] = _np(nl["w2"][i]).T
            sd[f"causal_mask.nonlinearities.{i}.net.2.bias"] = _np(nl["b2"][i])
        if "A" in params["causal_mask"]:
            sd["causal_mask.A"] = _np(params["causal_mask"]["A"])

    if "causal_flow" in params:
        for name in ("s_cond", "t_cond"):
            mlp = params["causal_flow"][name]
            for j, dense in ((0, "Dense_0"), (2, "Dense_1"), (4, "Dense_2")):
                _linear(sd, f"causal_flow.{name}.{j}", mlp[dense])

    for flax_prefix, torch_prefix, kinds in unet_walk(cfg):
        for j, kind in enumerate(kinds):
            tp = f"{torch_prefix}.{j}"
            p = params[f"{flax_prefix}_{j}"]
            if kind == "conv":
                _conv2d(sd, tp, p["Conv_0"])
            elif kind == "res":
                _resblock(sd, tp, p)
            elif kind == "attn":
                _attention(sd, tp, p)
            elif kind == "down":
                _conv2d(sd, f"{tp}.op", p["Conv3x3_0"]["Conv_0"])
            elif kind == "up":
                _conv2d(sd, f"{tp}.conv", p["Conv3x3_0"]["Conv_0"])

    _norm(sd, "out.0", params["out_norm"])
    _conv2d(sd, "out.2", params["out_conv"]["Conv_0"])
    # copy: transposes are views, and torch wants writable, owned buffers
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def _conv_trunk(sd, prefix, trunk_p, trunk_s) -> int:
    """A flax ``ConvTrunk`` under ``{prefix}.{i}.{0,1}``; returns its last width."""
    n_convs = sum(1 for k in trunk_p if k.startswith("Conv3x3_"))
    for i in range(n_convs):
        _conv2d(sd, f"{prefix}.{i}.0", trunk_p[f"Conv3x3_{i}"]["Conv_0"])
        _norm(sd, f"{prefix}.{i}.1", trunk_p[f"BatchNorm_{i}"])
        s = trunk_s[f"BatchNorm_{i}"]
        sd[f"{prefix}.{i}.1.running_mean"] = _np(s["mean"])
        sd[f"{prefix}.{i}.1.running_var"] = _np(s["var"])
        sd[f"{prefix}.{i}.1.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return sd[f"{prefix}.{n_convs - 1}.0.weight"].shape[0]


def classifier_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's probe ``state_dict`` (``models.encoder.GaussianConvEncoderClf``,
    reference keys ``encoder.{i}.{0,1}`` and ``fc``) from the JAX package's
    probe variables ``{"params", "batch_stats"}``, as ``ClassifierTrainer``
    pickles them. The head's input width gives the trunk's final grid, so no
    image size is needed."""
    sd: Dict[str, np.ndarray] = {}
    ch = _conv_trunk(sd, "encoder", variables["params"]["trunk"],
                     variables["batch_stats"]["trunk"])
    fc = variables["params"]["fc"]["Dense_0"]
    flat = _np(fc["kernel"]).shape[0]
    spatial = int(round((flat // ch) ** 0.5))
    if spatial * spatial * ch != flat:
        raise ValueError(f"probe head takes {flat} inputs, not a square grid of {ch} channels")
    _flatten_perm_linear(sd, "fc", fc, ch, spatial)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def flatten_variables(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"params/time_dense1/Dense_0/kernel": array, ...} (for .npz)."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_variables(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_variables`."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_weights(cfg, model: torch.nn.Module, path: str) -> None:
    """Load ``path`` into ``model`` with ``strict=True``.

    ``.npz``: flax variables saved with :func:`flatten_variables` keys.
    ``.pt``/``.pth``: a reference-key state_dict (e.g. a reference
    ``model*.pt`` or ``ema_*.pt``).
    """
    suffix = Path(path).suffix
    if suffix == ".npz":
        with np.load(path) as z:
            sd = state_dict_from_flax(cfg, unflatten_variables({k: z[k] for k in z.files}))
    elif suffix in (".pt", ".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"--init_from {path}: expected a .npz of flax variables or a .pt")
    model.load_state_dict(sd, strict=True)


@torch.no_grad()
def fill_normal_(model: torch.nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Overwrite EVERY parameter with N(0, std^2) draws from ``generator``.

    A fresh init zeroes each attention ``proj_out``, each ResBlock's last
    conv and the output conv, so the attention output would never reach eps;
    checks of the attention path fill all weights this way instead. Norm
    scales are drawn around 1 so activations keep their scale.
    """
    norms = (torch.nn.GroupNorm, torch.nn.BatchNorm2d)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        if isinstance(_owner(model, name), norms) and name.endswith("weight"):
            noise = noise + 1.0 / std
        p.copy_((noise * std).to(p.device, p.dtype))


def _owner(model: torch.nn.Module, param_name: str) -> torch.nn.Module:
    return model.get_submodule(param_name.rsplit(".", 1)[0]) if "." in param_name else model
