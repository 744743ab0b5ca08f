"""Gaussian diffusion process: the serving and training subsets.

Port of ``causaldiffae_tpu/diffusion/process.py:84-462``: the q process, the
eps <-> x0 conversions, ``p_mean_variance`` (classifier-free guidance
``w * cond + (1 - w) * uncond``, learned-range variance, clipping), the
single reverse steps the sampling chains loop over, the VLB terms and the
CausalDiffAE variational objective (``training_losses`` with the masked
representation KL).

The model is a black-box callable ``model_fn(x, t_model) -> eps`` on NHWC
tensors, with all conditioning bound by the caller. The coefficient arrays
stay float32 numpy on the host (``DiffusionSchedule``) and are copied to a
device once, on first use there. Randomness comes from an explicit
``torch.Generator`` on the tensors' device, or from noise the caller passes.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import sum_across_ranks
from ..parallel.grid import dp_group
from .losses import discretized_gaussian_log_likelihood, kl_normal, mean_flat, normal_kl
from .respace import respace_schedule, space_timesteps
from .schedule import DiffusionSchedule, get_named_beta_schedule, make_schedule

__all__ = [
    "ModelMeanType",
    "ModelVarType",
    "LossType",
    "GaussianDiffusion",
    "create_diffusion",
]


class ModelMeanType:
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType:
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType:
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class GaussianDiffusion:
    """Static diffusion process description.

    ``timestep_map`` is non-None iff this is a respaced process; model-facing
    timesteps are mapped back to the original process like the reference's
    `_WrappedModel` (`respace.py:112-124`).
    """

    def __init__(self, schedule: DiffusionSchedule, mean_type=ModelMeanType.EPSILON,
                 var_type=ModelVarType.FIXED_LARGE, loss_type=LossType.MSE,
                 rescale_timesteps: bool = False, timestep_map: Optional[np.ndarray] = None,
                 original_num_steps: Optional[int] = None):
        self.schedule = schedule
        self.mean_type = mean_type
        self.var_type = var_type
        self.loss_type = loss_type
        self.rescale_timesteps = rescale_timesteps
        self.timestep_map = timestep_map
        self.original_num_steps = original_num_steps
        self._on_device: Dict = {}

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def _array(self, name: str, device) -> torch.Tensor:
        """A schedule array (or derived ratio) as a tensor on ``device``."""
        key = (name, str(device))
        if key not in self._on_device:
            s = self.schedule
            if name == "timestep_map":
                arr = self.timestep_map.astype(np.int64)
            elif name == "xprev_coef1":
                arr = 1.0 / s.posterior_mean_coef1
            elif name == "xprev_coef2":
                arr = s.posterior_mean_coef2 / s.posterior_mean_coef1
            else:
                arr = getattr(s, name)
            self._on_device[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        return self._on_device[key]

    def arrays_on(self, device) -> None:
        """Copy every schedule array to ``device`` now. A traced program only
        reads the cache: filled under ``torch.export``, it would keep the
        trace's fake tensors (and a traced loop refuses the side effect), so
        an exporter calls this first."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:   # as a tensor's device reads
            device = torch.device("cuda", torch.cuda.current_device())
        names = list(self.schedule._fields) + ["xprev_coef1", "xprev_coef2"]
        if self.timestep_map is not None:
            names.append("timestep_map")
        missing = [n for n in names if (n, str(device)) not in self._on_device]
        if missing and torch.compiler.is_compiling():
            raise RuntimeError(f"the schedule arrays are not on {device}: call "
                               "diffusion.arrays_on(device) before tracing a chain")
        for name in missing:
            self._array(name, device)

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-timestep coefficients gathered and shaped [B, 1, ..., 1]."""
        out = self._array(name, t.device)[t]
        return out.reshape(out.shape[0], *([1] * (ndim - 1)))

    # ------------------------------------------------------------------ #
    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Timesteps as seen by the model: respacing map + optional rescale."""
        new_t = t
        if self.timestep_map is not None:
            new_t = self._array("timestep_map", t.device)[t]
        if self.rescale_timesteps:
            base = self.original_num_steps or self.num_timesteps
            return new_t.float() * (1000.0 / base)
        return new_t

    # ------------------------------------------------------------------ #
    # q process
    # ------------------------------------------------------------------ #
    def q_mean_variance(self, x_start, t):
        mean = self._extract("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
        variance = 1.0 - self._extract("alphas_cumprod", t, x_start.ndim)
        log_variance = self._extract("log_one_minus_alphas_cumprod", t, x_start.ndim)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        """Sample q(x_t | x_0) with given noise."""
        return (
            self._extract("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
            + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """Moments of q(x_{t-1} | x_t, x_0)."""
        posterior_mean = (
            self._extract("posterior_mean_coef1", t, x_t.ndim) * x_start
            + self._extract("posterior_mean_coef2", t, x_t.ndim) * x_t
        )
        posterior_variance = self._extract("posterior_variance", t, x_t.ndim)
        posterior_log_variance = self._extract("posterior_log_variance_clipped", t, x_t.ndim)
        return posterior_mean, posterior_variance, posterior_log_variance

    # ------------------------------------------------------------------ #
    # eps <-> x0 conversions
    # ------------------------------------------------------------------ #
    def predict_xstart_from_eps(self, x_t, t, eps):
        return (
            self._extract("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t
            - self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.ndim) * eps
        )

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return (
            self._extract("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t - pred_xstart
        ) / self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.ndim)

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        return (self._extract("xprev_coef1", t, x_t.ndim) * xprev
                - self._extract("xprev_coef2", t, x_t.ndim) * x_t)

    # ------------------------------------------------------------------ #
    # p process (model-driven)
    # ------------------------------------------------------------------ #
    def p_mean_variance(self, model_fn: ModelFn, x, t, clip_denoised: bool = True,
                        denoised_fn=None, w: Optional[float] = None,
                        uncond_fn: Optional[ModelFn] = None) -> Dict[str, torch.Tensor]:
        """Moments of p(x_{t-1} | x_t) plus the x_0 prediction.

        Classifier-free guidance: ``w * eps_cond + (1 - w) * eps_uncond``,
        with the unconditional branch supplied by the caller (z = 0).
        """
        t_model = self.model_t(t)
        if w is not None:
            if uncond_fn is None:
                raise ValueError("guidance requires an unconditional model fn")
            pred_cond = model_fn(x, t_model)
            pred_uncond = uncond_fn(x, t_model)
            model_output = w * pred_cond + (1.0 - w) * pred_uncond
        else:
            model_output = model_fn(x, t_model)

        if self.var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            if self.var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = self._extract("posterior_log_variance_clipped", t, x.ndim)
                max_log = self._extract("log_betas", t, x.ndim)
                frac = (model_var_values + 1) / 2  # [-1,1] -> [0,1]
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            var_name, logvar_name = {
                ModelVarType.FIXED_LARGE: ("fixed_large_variance", "fixed_large_log_variance"),
                ModelVarType.FIXED_SMALL: ("posterior_variance", "posterior_log_variance_clipped"),
            }[self.var_type]
            model_variance = self._extract(var_name, t, x.ndim)
            model_log_variance = self._extract(logvar_name, t, x.ndim)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            if clip_denoised:
                return x0.clamp(-1.0, 1.0)
            return x0

        if self.mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self.predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        elif self.mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        elif self.mean_type == ModelMeanType.EPSILON:
            pred_xstart = process_xstart(self.predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        else:
            raise NotImplementedError(self.mean_type)

        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance.expand(x.shape),
            "pred_xstart": pred_xstart,
        }

    # -- single reverse steps (looped over in sampling.py) --------------- #
    def p_sample(self, model_fn, x, t, generator=None, clip_denoised=True,
                 denoised_fn=None, w=None, uncond_fn=None, noise=None):
        """One ancestral (DDPM) reverse step."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, w=w, uncond_fn=uncond_fn)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model_fn, x, t, generator=None, clip_denoised=True,
                    denoised_fn=None, eta=0.0, w=None, uncond_fn=None, noise=None):
        """One DDIM reverse step (Song et al. Eq. 12).

        At ``eta == 0`` the step is deterministic and draws no noise.
        """
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, w=w, uncond_fn=uncond_fn)
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._extract("alphas_cumprod", t, x.ndim)
        alpha_bar_prev = self._extract("alphas_cumprod_prev", t, x.ndim)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps
        )
        if eta == 0 and noise is None:
            return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = mean_pred + nonzero_mask * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model_fn, x, t, clip_denoised=True, denoised_fn=None,
                            w=None, uncond_fn=None):
        """One deterministic DDIM inversion step x_t -> x_{t+1}."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, w=w, uncond_fn=uncond_fn)
        eps = (
            self._extract("sqrt_recip_alphas_cumprod", t, x.ndim) * x - out["pred_xstart"]
        ) / self._extract("sqrt_recipm1_alphas_cumprod", t, x.ndim)
        alpha_bar_next = self._extract("alphas_cumprod_next", t, x.ndim)
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_next)
            + torch.sqrt(1 - alpha_bar_next) * eps
        )
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    # ------------------------------------------------------------------ #
    # VLB terms
    # ------------------------------------------------------------------ #
    def vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True):
        """One VLB term in bits/dim: the decoder NLL at t = 0, else the KL."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"]))
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl / math.log(2.0))
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def prior_bpd(self, x_start):
        """Prior KL term KL(q(x_T | x_0) || N(0, I)) in bits/dim."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) / math.log(2.0)

    # ------------------------------------------------------------------ #
    # CausalDiffAE variational objective
    # ------------------------------------------------------------------ #
    @staticmethod
    def label_prior_mean(c: torch.Tensor, dim: int, scale=None) -> torch.Tensor:
        """Per-variable latent prior means from normalized labels: variable
        j's latent block has prior mean c[:, j] over its ``dim`` entries."""
        c = c.float()
        if scale is not None:
            scale = torch.as_tensor(scale, dtype=torch.float32, device=c.device)
            c = (c - scale[None, :, 0]) / scale[None, :, 1]
        return c[:, :, None].expand(*c.shape, dim)

    def representation_loss(self, mu, var, z_post, causal_modeling, mask, c):
        """KL objective on the semantic representation.

        KL(q(u|x) || N(0, I)) with q = (mu, var), ``var`` being the encoder's
        softplus'd output used as a variance; with ``causal_modeling`` plus
        sum_i KL(N(z_post_i, I) || N(c_i, I)). With a mask the result is the
        scalar sum(kl * mask) / max(sum(mask), 1) (the denominator guarded
        against an all-dropped batch); without one, per sample [N]. The mask
        is the keep-mask [N], or the flow prior's scalar -mean(log_det),
        whose sum is itself. Under data parallelism both sums run over the
        global batch (``parallel.sum_across_ranks`` over the DP group, whose
        ranks hold different rows; the flow's mask is global already), as the JAX step's do: each rank then holds the
        global scalar, and its gradient reaches every rank's rows.
        """
        num_vars = c.shape[1]
        dim = mu.shape[1] // num_vars
        kld = kl_normal(mu, var, torch.zeros_like(mu), torch.ones_like(var))
        if causal_modeling:
            zb = z_post.reshape(-1, num_vars, dim)
            ones = torch.ones_like(zb)
            kld = kld + kl_normal(zb, ones, self.label_prior_mean(c, dim), ones).sum(dim=1)
        if mask is None:
            return kld
        if mask.ndim == 0:
            return sum_across_ranks((kld * mask).sum(), dp_group()) / mask.clamp(min=1.0)
        num, count = sum_across_ranks(torch.stack([(kld * mask).sum(), mask.sum()]), dp_group())
        return num / count.clamp(min=1.0)

    def training_losses(self, forward_fn: Callable[[torch.Tensor, torch.Tensor],
                                                   Tuple[torch.Tensor, Dict]],
                        x_start: torch.Tensor, t: torch.Tensor, *,
                        c: Optional[torch.Tensor] = None, rep_cond: bool = False,
                        causal_modeling: bool = False, kl_weight=0.0,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Training loss terms for one batch of timesteps.

        ``forward_fn(x_t, t_model)`` returns ``(model_output, aux)``, where
        ``aux`` carries mu/var/z_post/mask from the encode path (empty
        without ``rep_cond``). The noise is ``noise`` when given, else drawn
        from ``generator``. ``kl_weight`` is the annealed weight of the
        representation KL. The learned-sigma ``vb`` term sees the mean
        detached, so it trains the variance only.
        """
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        t_model = self.model_t(t)

        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type in (LossType.KL, LossType.RESCALED_KL):
            terms["loss"] = self.vb_terms_bpd(lambda xx, tt: forward_fn(xx, tt)[0], x_start,
                                              x_t, t, clip_denoised=False)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output, aux = forward_fn(x_t, t_model)
        if rep_cond:
            terms["kld_rep"] = self.representation_loss(
                aux["mu"], aux["var"], aux["z_post"], causal_modeling, aux.get("mask"), c)

        if self.var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            frozen = torch.cat([model_output.detach(), model_var_values], dim=-1)
            terms["vb"] = self.vb_terms_bpd(lambda *_: frozen, x_start, x_t, t,
                                            clip_denoised=False)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)

        if "vb" in terms:
            terms["loss"] = terms["mse"] + terms["vb"]
        elif rep_cond:
            terms["loss"] = terms["mse"] + kl_weight * terms["kld_rep"]
        else:
            terms["loss"] = terms["mse"]
        return terms


def create_diffusion(*, steps: int = 1000, learn_sigma: bool = False,
                     sigma_small: bool = False, noise_schedule: str = "linear",
                     use_kl: bool = False, predict_xstart: bool = False,
                     rescale_timesteps: bool = False, rescale_learned_sigmas: bool = False,
                     timestep_respacing: str = "") -> GaussianDiffusion:
    """Factory mirroring reference `script_util.create_gaussian_diffusion`,
    returning a respaced process when ``timestep_respacing`` is non-empty."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    mean_type = ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    else:
        var_type = ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE

    if timestep_respacing:
        use_ts = space_timesteps(steps, timestep_respacing)
        schedule, timestep_map = respace_schedule(betas, use_ts)
        return GaussianDiffusion(schedule, mean_type, var_type, loss_type,
                                 rescale_timesteps, timestep_map, steps)
    return GaussianDiffusion(make_schedule(betas), mean_type, var_type, loss_type,
                             rescale_timesteps, None, steps)
