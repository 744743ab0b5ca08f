"""Training state: the model, its optimizer, the EMA copies and the sampler.

Port of ``causaldiffae_tpu/training/state.py:34-47,151-159``. Where the JAX
package carries one immutable pytree through a jitted step, the port keeps a
plain ``TrainState`` whose tensors the step updates in place: fp32
parameters in the model (bf16 compute comes from the per-call weight casts),
``torch.optim.AdamW`` state, one fp32 EMA copy of every parameter per rate
(keyed by the rate string, as ``ema_rates`` gives them), the sampler's host
state and the step count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..utils import tracing
from .samplers import SamplerState, init_sampler_state

__all__ = ["TrainState", "create_train_state", "make_optimizer", "anneal_lr_",
           "ema_rates", "kl_weight_for_step"]


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, Dict[str, torch.Tensor]]   # rate string -> {parameter name: fp32 copy}
    sampler_state: SamplerState
    step: int = 0


def make_optimizer(cfg, params) -> torch.optim.AdamW:
    """AdamW as optax's ``adamw``: b1 0.9, b2 0.999, eps 1e-8, decoupled
    decay ``p <- p - lr * (adam + weight_decay * p)``. Fused, so that a step
    can be skipped on the device (``found_inf``) without a host sync; the
    linear LR anneal is set before each step by :func:`anneal_lr_`."""
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay, fused=True)


def anneal_lr_(optimizer: torch.optim.Optimizer, cfg) -> None:
    """The reference's linear LR anneal, lr * (1 - n / lr_anneal_steps), with
    n the updates applied so far (optax's count: a skipped step does not
    advance it). Read from the optimizer's own on-device step, so no sync."""
    if not cfg.lr_anneal_steps:
        return
    group = optimizer.param_groups[0]
    state = optimizer.state.get(group["params"][0])
    if not state:
        lr = torch.tensor(cfg.lr, dtype=torch.float32, device=group["params"][0].device)
    else:
        lr = cfg.lr * (1.0 - state["step"].float() / cfg.lr_anneal_steps)
    for g in optimizer.param_groups:
        g["lr"] = lr


def ema_rates(cfg) -> List[str]:
    return [r for r in str(cfg.ema_rate).split(",") if r]


@tracing.traced("cdae.setup.train_state")
def create_train_state(cfg, model: torch.nn.Module) -> TrainState:
    """Optimizer, EMA copies equal to the parameters, fresh sampler state."""
    params = list(model.parameters())
    return TrainState(
        model=model,
        optimizer=make_optimizer(cfg, params),
        ema={r: {n: p.detach().float().clone() for n, p in model.named_parameters()}
             for r in ema_rates(cfg)},
        sampler_state=init_sampler_state(cfg.schedule_sampler, cfg.diffusion_steps),
    )


def kl_weight_for_step(step: int, total_steps: int) -> float:
    """Linear KL-weight anneal from 0 to 1, in fp32 as the JAX package
    computes it, on the step count BEFORE the step's increment: weight
    step / (total - 1), clamped to [0, 1]. Kept in the JAX package's form
    (1 - t)·0 + t·1, so that an infinite t (total = 1) gives NaN there too."""
    t = np.float32(step) / np.float32(total_steps - 1)
    w = (np.float32(1.0) - t) * np.float32(0.0) + t
    return float(np.clip(w, np.float32(0.0), np.float32(1.0)))
