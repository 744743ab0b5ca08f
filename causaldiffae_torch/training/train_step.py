"""The training step.

Port of ``causaldiffae_tpu/training/train_step.py:54-212``: timestep
sampling, the q_sample + UNet forward + variational loss, backward (through
the attention backward kernel on the card), the global grad norm, a step
skipped on a non-finite grad norm, AdamW, the EMA and the loss-aware
sampler's update. Microbatching sums the gradients of the per-microbatch
MEAN losses, and the encoder's BatchNorm running statistics thread through
the microbatches in order (they update in place on each forward). Under
data parallelism (``make_train_step`` on a DDP-wrapped model) W ranks take
the step one process at the global batch takes: the same global draws,
each rank its rows, and every batch reduction global. Under tensor
parallelism (a model cut by ``parallel.shard_model_``) the W ranks are a
grid of data rows by TP ranks: the TP ranks of a row hold the same rows and
take the same draws, so "rank" and "W" here are the DP rank and size, the
batch reductions run over the DP group, and the grad and param norms sum
the sharded tensors' squares over the TP group and count the replicated
ones once, so that every rank holds the same norms and skips a step with
all the others. The EMA runs on each rank's shard.

The metrics come back as tensors on the device; the loop reads them at its
log interval. (The loss-second-moment sampler, not the presets' default,
reads t and the losses back every step for its host-side history.) One copy
blocks the host each step: ``kl_weight``'s, host to device, which waits for
the step's device work.

A step runs in the span ``cdae.train.step`` (``utils/tracing.py``), with the
children ``.forward`` (each microbatch's losses), ``.backward``,
``.optimizer`` (the gradient norm, ``found_inf`` and AdamW), ``.ema`` and
``.metrics`` (the metrics' device scalars), and in ``.metrics`` ``.wait``:
that copy alone.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from ..diffusion.process import GaussianDiffusion
from ..parallel import dp_rank, dp_size, rank_rows, tp_group
from ..parallel.collectives import all_reduce_
from ..utils import tracing
from .samplers import sample_timesteps, timestep_weights, update_sampler_state
from .state import TrainState, anneal_lr_, ema_rates, kl_weight_for_step

__all__ = ["make_train_step", "compute_losses", "global_norm", "step_seed"]

DRAW_KEYS = ("t", "noise", "rep_noise", "keep")


def global_norm(tensors, sharded=None) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32. ``sharded``: (the
    tensors' 0/1 flags, fp32, the TP group) when some are shards of a tensor
    cut over that group, whose squares are then summed over it (one
    all-reduce; no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if sharded is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    flags, group = sharded
    squares = torch.stack(norms).pow(2)
    parts = all_reduce_((squares * flags).sum(), group)
    return torch.sqrt(parts + (squares * (1 - flags)).sum())


def step_seed(seed: int, step: int) -> int:
    """The draws' generator seed for ``step`` of a run seeded ``seed``."""
    return seed * 1_000_003 + step


def _quartile_means(t: torch.Tensor, values: torch.Tensor,
                    num_timesteps: int) -> Dict[str, torch.Tensor]:
    """Per-quartile-of-t means of ``values`` and their counts."""
    q = 4 * t // num_timesteps
    out = {}
    for i in range(4):
        m = (q == i).float()
        out[f"q{i}"] = (values * m).sum() / m.sum().clamp(min=1.0)
        out[f"q{i}_count"] = m.sum()
    return out


def compute_losses(cfg, model: torch.nn.Module, diffusion: GaussianDiffusion,
                   images: torch.Tensor, cond: Dict[str, torch.Tensor], t: torch.Tensor,
                   kl_weight: float, *, noise: Optional[torch.Tensor] = None,
                   rep_noise: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
                   drop: Optional[Callable[[torch.Size], torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The loss terms of one (micro)batch, as the JAX ``loss_fn`` computes them.

    Draws not given come from ``generator``: the diffusion noise first,
    then, inside the model, the reparameterization noise, the keep-mask and
    the dropout masks (``drop``, one per ResBlock).
    """
    def forward(x_t, t_model):
        kwargs = {}
        if cfg.class_cond:
            kwargs["y"] = cond["y"]
        if cfg.context_cond:
            kwargs["c"] = cond["c"]
        if cfg.rep_cond:
            kwargs["x_start"] = images
        return model(x_t, t_model, rep_noise=rep_noise, keep=keep, drop=drop,
                     generator=generator, **kwargs)

    return diffusion.training_losses(forward, images, t, c=cond.get("c"), rep_cond=cfg.rep_cond,
                                     causal_modeling=cfg.causal_modeling, kl_weight=kl_weight,
                                     noise=noise, generator=generator)


def _rank_draws(cfg, draws, gen, micro: int, k: int, mine: slice, image_shape,
                dropout: float, device):
    """This rank's share (``mine``) of microbatch ``k``'s draws, each drawn
    over the GLOBAL microbatch of ``micro`` rows in the order one process
    draws them: the diffusion noise, then (with a representation) the
    reparameterization noise and (with ``masking``) the keep-mask, from
    ``draws`` when handed in, else from ``gen``; and the dropout mask
    source, which draws from ``gen`` as the ResBlocks run."""
    rows = slice(k * micro, (k + 1) * micro)
    # the ResBlocks ask for their full width, also where tensor parallelism
    # cuts them (``ResBlock.keep_mask``), so every TP rank draws what one
    # process draws

    def draw(key, make):
        return (draws[key][rows] if key in draws else make())[mine]

    out = {"noise": draw("noise", lambda: torch.randn((micro, *image_shape), generator=gen,
                                                      device=device))}
    if cfg.rep_cond:
        out["rep_noise"] = draw("rep_noise", lambda: torch.randn(
            (micro, cfg.rep_dim), generator=gen, device=device))
        if cfg.masking:
            out["keep"] = draw("keep", lambda: torch.bernoulli(
                torch.full((micro,), 1.0 - cfg.drop_prob, device=device), generator=gen))
    out["drop"] = lambda shape: torch.empty((micro, *shape[1:]), device=device).bernoulli_(
        1.0 - dropout, generator=gen)[mine]
    return out


@tracing.traced("cdae.setup.train_step")
def make_train_step(cfg, model: torch.nn.Module, diffusion: GaussianDiffusion,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """Build ``train_step(state, batch, *, draws=None) -> metrics``.

    ``model`` is the CausalUNet, or under data parallelism its
    ``DistributedDataParallel`` wrapper. ``batch`` holds 'image' [n, H, W, C]
    and, as the config needs them, 'y' [n] and 'c' [n, n_vars], on the
    model's device: the whole batch in one process, else this rank's share
    of the global batch of B = n * W rows, the rows ``parallel.rank_rows``
    names, in that order. ``draws`` may hand in every random draw for the
    whole GLOBAL batch: 't' [B], 'noise' (the global image shape),
    'rep_noise' [B, rep_dim] and 'keep' [B]. Otherwise they come from a
    generator seeded from ``step_seed(cfg.seed, state.step)``, drawn at the
    global batch's shapes on every rank, so that W ranks take the step one
    process at B takes. The step updates ``state`` in place and returns the
    metrics as device tensors, this rank's (``parallel.reduce_metrics``
    makes them global).

    Microbatching: a global microbatch holds ``cfg.microbatch`` rows, each
    rank's share ``cfg.microbatch / W``; each rank sums the gradients of its
    microbatches' mean losses (DDP all-reduces them after the last one,
    the others run under ``no_sync``). Every batch reduction inside the
    loss runs over the global (micro)batch (``parallel.sum_across_ranks``).
    """
    ddp = isinstance(model, DistributedDataParallel)
    base = model.module if ddp else model
    rates = [(r, float(r)) for r in ema_rates(cfg)]
    named = list(base.named_parameters())
    params = [p for _, p in named]
    plan = getattr(base, "shard_plan", None)
    sharded = None
    if plan is not None and plan.leaves:
        flags = torch.tensor([float(n in plan.leaves) for n, _ in named],
                             device=params[0].device)
        sharded = (flags, tp_group())

    @tracing.traced("cdae.train.step")
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        base.train()
        images = batch["image"]
        n = images.shape[0]
        W, r = dp_size(), dp_rank()
        B = n * W
        device = images.device
        cond = {k: v for k, v in batch.items() if k != "image"}
        draws = dict(draws or {})
        if set(draws) - set(DRAW_KEYS):
            raise KeyError(f"unknown draws {sorted(set(draws) - set(DRAW_KEYS))}")
        gen = torch.Generator(device=device).manual_seed(step_seed(cfg.seed, state.step))
        micro = cfg.microbatch if 0 < cfg.microbatch < B else B
        share = micro // W
        mine = slice(r * share, (r + 1) * share)  # of each global microbatch: rank_rows

        num_t = diffusion.num_timesteps
        if "t" in draws:
            t_all = draws["t"]
            weights_all = timestep_weights(state.sampler_state, num_t, t_all)
        else:
            t_all, weights_all = sample_timesteps(state.sampler_state, num_t, B, gen, device)
        t, weights = (v.reshape(-1, micro)[:, mine].reshape(-1) for v in (t_all, weights_all))
        kl_weight = kl_weight_for_step(state.step, cfg.kl_anneal_steps)

        optimizer.zero_grad(set_to_none=True)
        parts = []
        for i, lo in enumerate(range(0, n, share)):
            sl = slice(lo, lo + share)
            drawn = _rank_draws(cfg, draws, gen, micro, i, mine, images.shape[1:], base.dropout,
                                device)
            sync = not ddp or lo + share == n
            with contextlib.nullcontext() if sync else model.no_sync():
                with tracing.span("cdae.train.step.forward"):
                    terms = compute_losses(cfg, model, diffusion, images[sl],
                                           {k: v[sl] for k, v in cond.items()}, t[sl], kl_weight,
                                           generator=gen, **drawn)
                with tracing.span("cdae.train.step.backward"):
                    (terms["loss"] * weights[sl]).mean().backward()
            parts.append({k: v.detach() for k, v in terms.items()})
        terms = {k: (torch.cat([p[k].reshape(-1) for p in parts]) if parts[0][k].ndim
                     else torch.stack([p[k] for p in parts]).mean()) for k in parts[0]}

        loss_vec = terms["loss"].expand(n)
        state.sampler_state = update_sampler_state(state.sampler_state, t, loss_vec,
                                                   rank_rows(B, W, r, micro))
        with tracing.span("cdae.train.step.optimizer"):
            for p in params:  # as jax.grad, every parameter has a gradient (zeros if unused)
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grad_norm = global_norm([p.grad for p in params], sharded)
            nonfinite = (~torch.isfinite(grad_norm)).float()
            optimizer.found_inf = nonfinite if cfg.skip_nonfinite else None
            anneal_lr_(optimizer, cfg)
            optimizer.step()  # with found_inf = 1 the fused step leaves params, moments, step

        with tracing.span("cdae.train.step.ema"), torch.no_grad():
            for rate_str, rate in rates:
                ema = [state.ema[rate_str][n] for n, _ in named]
                torch._foreach_mul_(ema, rate)
                torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - rate)

        with tracing.span("cdae.train.step.metrics"):
            loss = (loss_vec * weights).mean()
            param_norm = global_norm([p.detach() for p in params], sharded)
            with tracing.span("cdae.train.step.wait"):   # blocks until the device drains
                kl = torch.tensor(kl_weight, dtype=torch.float32, device=device)
            metrics = {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm,
                       "kl_weight": kl}
            if "mse" in terms:
                metrics["mse"] = (terms["mse"] * weights).mean()
            if cfg.skip_nonfinite:
                metrics["step_skipped"] = nonfinite
            if "kld_rep" in terms:
                metrics["kld_rep"] = terms["kld_rep"].mean()
            if "vb" in terms:
                metrics["vb"] = (terms["vb"] * weights).mean()
            if state.sampler_state is not None:
                counts = state.sampler_state["counts"]
                size = state.sampler_state["history"].shape[1]
                metrics["sampler_warmed"] = torch.tensor(float((counts == size).all()),
                                                         device=device)
                metrics["sampler_warmup_frac"] = torch.tensor(float((counts / size).mean()),
                                                              device=device)
            for key in ("loss", "mse"):
                if key in terms:
                    vals = terms[key].expand(n) * weights
                    for name, v in _quartile_means(t, vals, num_t).items():
                        metrics[f"{key}_{name}"] = v
        state.step += 1
        return metrics

    return train_step
