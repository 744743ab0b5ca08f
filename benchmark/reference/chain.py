"""Plain reference of a counterfactual request, and the check of an answer.

A request holds images x (NHWC in [-1, 1]), class labels y, one intervention
do(variable = value), and the two draws the answer depends on: the
representation's noise and the abduction noise. The answer is made as the
paper makes it (arXiv:2404.17735, the reference repository's
``image_causaldae_test.py``): encode x with the encoder's running
statistics; a root variable's block of u is overwritten before the SCM, an
effect's block of z_post after it; z = z_post + sqrt(1e-3) * rep_noise;
abduct x_t = q_sample(x, t_abduct, noise) in the respaced process; then run
DPM-Solver++(2M) from x_t, conditioned on z.

The check follows the program's chain step by step: a DPM++ step's result
depends on its input, and on random weights the chain carries any rounding
change forward, so the reference takes each step from the program's state
and compares the step's result with the program's next state; the last
result is the answer. The start is the reference's own: its z (encoder,
do(), SCM, the draw), which every step's UNet call takes, and its q_sample,
which the first step takes.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import diffusion as D
from . import model as M


def latent(P, m: dict, adjacency, x, var: int, value: float, rep_noise, cast=M.identity):
    """z of the counterfactual world."""
    mu, _ = M.encode(P, m, x, train=False, cast=cast)
    d = mu.shape[1] // m["n_vars"]
    block = slice(var * d, (var + 1) * d)
    root = sum(row[var] for row in adjacency) == 0
    if root:
        mu = mu.clone()
        mu[:, block] = value
    z_post = M.causalize(P, m, mu, adjacency)
    if not root:
        z_post = z_post.clone()
        z_post[:, block] = value
    return z_post + (m["reparam_var_scale"] ** 0.5) * rep_noise


class Chain:
    """The respaced process and the DPM++ grid of one serving configuration."""

    def __init__(self, m: dict, respacing: int, sample_steps: int, abduction_t: int, device):
        self.process = D.Process(m["diffusion_steps"], device, respacing)
        self.nodes = self.process.dpm_nodes(sample_steps)
        self.abduction_t = abduction_t

    @property
    def unet_calls(self) -> int:
        return len(self.nodes["t"])

    def start(self, x, noise):
        t = torch.full((len(x),), self.abduction_t, dtype=torch.long, device=x.device)
        return self.process.q_sample(x, t, noise)

    def step(self, P, m, i: int, x, x0_prev, y, z, cast=M.identity):
        """(next state, x0) of DPM++ step ``i`` from state ``x``."""
        nd = self.nodes
        t = torch.full((len(x),), int(nd["t"][i]), dtype=torch.long, device=x.device)
        eps = M.unet(P, m, x, self.process.model_t(t), y=y, z=z, cast=cast)
        x0 = self.process.pred_x0(x, t, eps)
        d = x0 + float(nd["c2"][i]) * (x0 - x0_prev)
        return float(nd["sratio"][i]) * x - float(nd["a_next"][i] * nd["phi"][i]) * d, x0

    def run(self, P, m, adjacency, req: dict, cast=M.identity) -> dict:
        """The whole answer, with what the check reads: each UNet call's
        input state, and the answer."""
        z = latent(P, m, adjacency, req["x"], req["var"], req["value"], req["rep_noise"], cast)
        x = self.start(req["x"], req["abduction_noise"])
        x0_prev, states = torch.zeros_like(x), []
        for i in range(self.unet_calls):
            states.append(x)
            x, x0_prev = self.step(P, m, i, x, x0_prev, req.get("y"), z, cast)
        return {"states": states, "answer": x}


def _worst_image(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-image ||got - want|| / ||want||."""
    diff = (got.float() - want).flatten(1).norm(dim=1)
    return float((diff / want.flatten(1).norm(dim=1).clamp(min=1e-12)).max())


@torch.no_grad()
def check(chain: Chain, P, m: dict, adjacency, req: dict, got: dict) -> Dict[str, float]:
    """``step_gap`` of the program's answer ``got`` (as :meth:`Chain.run`
    returns it) to request ``req``: the worst image's relative distance
    between a step's result and the program's next state, over the steps."""
    z = latent(P, m, adjacency, req["x"], req["var"], req["value"], req["rep_noise"])
    states: List[torch.Tensor] = got["states"]
    if len(states) != chain.unet_calls:
        return {"step_gap": float("inf")}
    x0_prev, worst = None, 0.0
    nexts = states[1:] + [got["answer"]]
    for i in range(chain.unet_calls):
        x = chain.start(req["x"], req["abduction_noise"]) if i == 0 else states[i].float()
        if x0_prev is None:
            x0_prev = torch.zeros_like(x)
        want, x0_prev = chain.step(P, m, i, x, x0_prev, req.get("y"), z)
        worst = max(worst, _worst_image(nexts[i], want))
    return {"step_gap": worst}
