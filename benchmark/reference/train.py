"""Plain reference of the CausalDiffAE train step: loss, gradient, AdamW, EMA.

The objective is the paper's (arXiv:2404.17735, the reference repository's
``gaussian_diffusion.training_losses``): the eps MSE of the UNet at x_t =
q_sample(x0, t, noise), plus the annealed KL of the representation,
KL(q(u | x) || N(0, I)) + sum_i KL(N(z_post_i, I) || N(c_i, I)), averaged
over the rows that the keep-mask keeps. The representation z = z_post +
sqrt(1e-3 var) * rep_noise feeds the UNet, gated by the keep-mask. The
optimizer is AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay), then an
EMA of the parameters. Every random draw is handed in.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from . import diffusion as D
from . import model as M


def loss(P, m: dict, adjacency, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
         step: int, process: D.Process, cast=M.identity, layer_hook=None) -> torch.Tensor:
    """The step's scalar loss on ``batch`` (NHWC 'image', 'c', and 'y' where
    the model is class-conditional) with ``draws`` (t, noise, rep_noise, keep)."""
    x0, t = batch["image"], draws["t"]
    mu, var = M.encode(P, m, x0, train=True, cast=cast)
    z_post = M.causalize(P, m, mu, adjacency)
    z = z_post + torch.sqrt(var * m["reparam_var_scale"]) * draws["rep_noise"]
    keep = draws["keep"]
    z, z_post = z * keep[:, None], z_post * keep[:, None]
    eps = M.unet(P, m, process.q_sample(x0, t, draws["noise"]), process.model_t(t),
                 y=batch.get("y"), z=z, cast=cast, layer_hook=layer_hook)
    mse = ((draws["noise"] - eps) ** 2).flatten(1).mean(1)
    n = m["n_vars"]
    zb = z_post.reshape(len(z_post), n, -1)
    ones = torch.ones_like(zb)
    prior = batch["c"].float()[:, :, None].expand_as(zb)
    kld = D.kl_normal(mu, var, torch.zeros_like(mu), torch.ones_like(var)) \
        + D.kl_normal(zb, ones, prior, ones).sum(1)
    kld_rep = (kld * keep).sum() / keep.sum().clamp(min=1.0)
    return (mse + D.kl_weight(step, m["kl_anneal_steps"]) * kld_rep).mean()


def train(P0: Dict[str, torch.Tensor], m: dict, adjacency, batches: List[dict], draws: List[dict],
          cast=M.identity, layer_hook=None) -> dict:
    """Run ``len(batches)`` steps from the weights ``P0`` (parameters and the
    encoder's BatchNorm buffers; left as they are). Returns each step's loss,
    the first step's gradient, and the parameters and EMA after the last."""
    names = list(M.param_shapes(m))
    P = {k: (v.detach().clone().requires_grad_(True) if k in names else v.clone())
         for k, v in P0.items()}
    params = [P[k] for k in names]
    mom = [torch.zeros_like(p) for p in params]
    sec = [torch.zeros_like(p) for p in params]
    ema = [p.detach().clone() for p in params]
    lr, b1, b2, eps, wd = m["lr"], 0.9, 0.999, 1e-8, m["weight_decay"]
    rate = float(m["ema_rate"])
    process = D.Process(m["diffusion_steps"], params[0].device)
    out = {"loss": []}
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        total = loss(P, m, adjacency, batch, dr, i, process, cast, layer_hook)
        grads = torch.autograd.grad(total, params)
        out["loss"].append(float(total.detach()))
        if i == 0:
            out["grad"] = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            n = i + 1
            for p, g, mm, vv, e in zip(params, grads, mom, sec, ema):
                mm.mul_(b1).add_((1 - b1) * g)
                vv.mul_(b2).add_((1 - b2) * g * g)
                p.mul_(1 - lr * wd)
                p.sub_(lr * (mm / (1 - b1 ** n)) / ((vv / (1 - b2 ** n)).sqrt() + eps))
                e.mul_(rate).add_((1 - rate) * p)
        del grads, total
    out["params"] = {k: p.detach() for k, p in zip(names, params)}
    out["ema"] = dict(zip(names, ema))
    return out


def checkpointed(fn, *args):
    """A block whose activations are recomputed in the backward pass (the
    same values; less memory at full width)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def leaves(m: dict, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tensors as the comparison takes them: every parameter, with each
    attention projection's bias cut into its query, key and value parts, so
    that the key's bias, which has no gradient under softmax, is a leaf of
    its own (see :func:`moved_leaves`)."""
    out = {}
    for k, v in tensors.items():
        if k.endswith(".qkv.bias"):
            heads = m["num_heads"]
            parts = v.reshape(heads, 3, -1)
            for j, part in enumerate("qkv"):
                out[f"{k}.{part}"] = parts[:, j]
        else:
            out[k] = v
    return out


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keys) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    ref = {k: float(reference[k].double().norm()) for k in keys}
    prog = {k: float(program[k].double().norm()) for k in keys}
    med = float(torch.tensor(list(ref.values()), dtype=torch.float64).median())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def norm_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keys) -> float:
    """The worst leaf's :func:`leaf_gaps`."""
    return max(leaf_gaps(program, reference, keys).values())


def worst_leaves(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                 n: int = 5) -> List[tuple]:
    """The ``n`` leaves that set :func:`norm_gap`: (gap, leaf, program norm,
    reference norm, median reference norm), worst first."""
    ref = {k: float(reference[k].double().norm()) for k in reference}
    prog = {k: float(program[k].double().norm()) for k in reference}
    med = float(torch.tensor(list(ref.values()), dtype=torch.float64).median())
    rows = [(abs(prog[k] - ref[k]) / max(ref[k], med), k, prog[k], ref[k], med) for k in ref]
    return sorted(rows, reverse=True)[:n]


def moved_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's. The others have no gradient but round-off: the key's
    bias under softmax, and a convolution's bias that train-mode BatchNorm
    follows (the encoder's, whose batch mean takes it away); their
    gradient is rounding noise on either side, and under Adam they move by
    it alone, so neither their gradient nor their change is compared."""
    norms = {k: float(v.double().norm()) for k, v in grad.items()}
    med = float(torch.tensor(list(norms.values()), dtype=torch.float64).median())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def compare(m: dict, ref: dict, prog: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of a training cell: each step's loss gap (the worst,
    relative to the reference's loss), the first gradient's worst leaf and
    its median leaf, and the change of the parameters and of the EMA after
    the steps, worst leaf, over the leaves that :func:`moved_leaves` keeps.
    The median leaf's gradient is where the rounding of every product shows:
    a gap of norms moves with the square of the rounding, which the worst,
    smallest leaves and the loss hide.
    ``prog`` holds the program's 'loss' list, 'grad', 'params' and 'ema'
    (its tensors by parameter name); ``start`` the weights before step 1."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    g_ref, g_prog = leaves(m, ref["grad"]), leaves(m, prog["grad"])
    moved = moved_leaves(g_ref)
    gaps = leaf_gaps(g_prog, g_ref, moved)
    out = {"loss_gap": loss_gap, "grad_gap": max(gaps.values()),
           "grad_gap_median": statistics.median(gaps.values())}
    for key in ("params", "ema"):
        d_ref = leaves(m, {k: ref[key][k] - start[k] for k in ref[key]})
        d_prog = leaves(m, {k: prog[key][k].to(start[k].device) - start[k] for k in ref[key]})
        out["update_gap" if key == "params" else "ema_gap"] = norm_gap(d_prog, d_ref, moved)
    return out


__all__ = ["loss", "train", "checkpointed", "leaves", "leaf_gaps", "norm_gap", "moved_leaves",
           "compare"]
