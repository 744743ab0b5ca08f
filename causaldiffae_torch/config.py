"""Configuration: typed dataclasses + named presets.

Port of ``causaldiffae_tpu/config.py`` without its JAX import: the compute
dtype is a torch dtype (``Config.dtype``). The fields keep the JAX package's
names, except ``use_pallas``, which is ``use_kernels`` here: with bf16 compute
it routes attention through the CUDA kernel (``ops/attention.py``); fp32
always takes the plain ``qkv_attention`` path, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .utils import tracing

NUM_CLASSES = 10  # script_util.py:9

# Causal graphs (row=cause -> col=effect).
ADJACENCY = {
    # thickness -> intensity
    "morphomnist": ((0.0, 1.0), (0.0, 0.0)),
    # arm -> {blue, green, red}; blue,green -> red
    "circuit": (
        (0.0, 1.0, 1.0, 1.0),
        (0.0, 0.0, 0.0, 1.0),
        (0.0, 0.0, 0.0, 1.0),
        (0.0, 0.0, 0.0, 0.0),
    ),
    # {angle, light} -> {shadow_len, shadow_pos}
    "pendulum": (
        (0.0, 0.0, 1.0, 1.0),
        (0.0, 0.0, 1.0, 1.0),
        (0.0, 0.0, 0.0, 0.0),
        (0.0, 0.0, 0.0, 0.0),
    ),
}

# Dataset label normalization scales [(offset, divisor), ...] per variable.
DATA_SCALES = {
    "morphomnist": ((3.4, 2.4), (161.0, 94.0)),
    "pendulum": ((2.0, 42.0), (104.0, 44.0), (7.5, 4.5), (11.0, 8.0)),
    "circuit": ((0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0)),
}


def channel_mult_for(image_size: int) -> Tuple[int, ...]:
    """Channel multipliers per resolution level (reference `script_util.py:140-153`)."""
    table = {
        256: (1, 1, 2, 2, 4, 4),
        128: (1, 1, 2, 2, 4, 4),
        96: (1, 2, 3, 4),
        64: (1, 2, 3, 4),
        32: (1, 2, 2, 2),
        28: (1, 2, 2),
    }
    if image_size not in table:
        raise ValueError(f"unsupported image size: {image_size}")
    return table[image_size]


def attention_ds(image_size: int, attention_resolutions: str) -> Tuple[int, ...]:
    """Resolution list -> downsample-ratio list (reference `script_util.py:155-157`)."""
    return tuple(image_size // int(r) for r in attention_resolutions.split(","))


@dataclasses.dataclass(frozen=True)
class Config:
    """One experiment = model + diffusion + training + data + eval settings."""

    name: str = "morphomnist_causaldae"
    dataset: str = "morphomnist"

    # --- model ---
    image_size: int = 28
    in_channels: int = 1
    num_channels: int = 128
    num_res_blocks: int = 3
    num_heads: int = 4
    num_heads_upsample: int = -1
    attention_resolutions: str = "16,8"
    dropout: float = 0.0
    learn_sigma: bool = False
    sigma_small: bool = False
    class_cond: bool = False
    context_cond: bool = False
    rep_cond: bool = False
    rep_dim: int = 512
    n_vars: int = 2
    causal_modeling: bool = False
    flow_based: bool = False
    learn_adjacency: bool = False
    masking: bool = False
    drop_prob: float = 0.5
    reparam_var_scale: float = 1e-3
    use_scale_shift_norm: bool = True
    use_bf16: bool = False
    use_kernels: bool = True

    # --- diffusion ---
    diffusion_steps: int = 1000
    noise_schedule: str = "linear"
    timestep_respacing: str = ""
    use_kl: bool = False
    predict_xstart: bool = False
    rescale_timesteps: bool = False
    rescale_learned_sigmas: bool = False

    # --- training ---
    lr: float = 1e-4
    weight_decay: float = 0.0
    batch_size: int = 128
    microbatch: int = -1
    ema_rate: str = "0.9999"
    lr_anneal_steps: int = 0
    total_steps: int = 14000
    kl_anneal_steps: int = 50000
    log_interval: int = 10
    save_interval: int = 10000
    schedule_sampler: str = "uniform"
    use_remat: bool = False       # recompute each ResBlock in the backward pass
    skip_nonfinite: bool = True
    seed: int = 0
    model_parallel: int = 1       # TP ranks per data row (parallel/grid.py)

    # --- eval ---
    eval_timestep_respacing: str = "250"
    eval_use_ddim: bool = True
    abduction_t: int = 249
    clip_denoised: bool = True
    guidance_w: Optional[float] = None
    num_samples: int = 160

    @property
    def adjacency(self):
        return ADJACENCY[self.dataset] if self.causal_modeling else None

    @property
    def label_scale(self):
        return DATA_SCALES[self.dataset]

    @property
    def channel_mult(self) -> Tuple[int, ...]:
        return channel_mult_for(self.image_size)

    @property
    def attention_ds(self) -> Tuple[int, ...]:
        return attention_ds(self.image_size, self.attention_resolutions)

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bf16 else torch.float32

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@tracing.traced("cdae.setup.create_model")
def create_model(cfg: Config, device="cuda"):
    """Build the CausalUNet from a Config, in eval mode on ``device``.

    ``model.train()`` switches it to the training forward's semantics (the
    encoder's BatchNorm on batch statistics)."""
    from .models.unet import CausalUNet

    model = CausalUNet(
        in_channels=cfg.in_channels,
        model_channels=cfg.num_channels,
        out_channels=cfg.out_channels,
        num_res_blocks=cfg.num_res_blocks,
        attention_resolutions=cfg.attention_ds,
        channel_mult=cfg.channel_mult,
        image_size=cfg.image_size,
        num_classes=NUM_CLASSES if cfg.class_cond else None,
        # the context is the dataset's label vector: flax's Dense takes its
        # width from the batch, so the JAX model's c_dense1 is [n_labels, 256]
        c_dim=len(DATA_SCALES[cfg.dataset]) if cfg.context_cond else None,
        rep_dim=cfg.rep_dim if cfg.rep_cond else None,
        causal_modeling=cfg.causal_modeling,
        flow_based=cfg.flow_based,
        dropout=cfg.dropout,
        num_heads=cfg.num_heads,
        num_heads_upsample=cfg.num_heads_upsample,
        use_scale_shift_norm=cfg.use_scale_shift_norm,
        n_vars=cfg.n_vars,
        adjacency=ADJACENCY[cfg.dataset] if (cfg.causal_modeling or cfg.flow_based) else None,
        learn_adjacency=cfg.learn_adjacency,
        masking=cfg.masking,
        drop_prob=cfg.drop_prob,
        reparam_var_scale=cfg.reparam_var_scale,
        dtype=cfg.dtype,
        use_kernels=cfg.use_kernels,
        use_remat=cfg.use_remat,
    )
    return model.to(device).eval()


def create_sr_model(cfg: Config, large_size: int = 256, small_size: int = 64, device="cuda"):
    """Super-resolution model (``causaldiffae_tpu/config.py:203-223``, the
    reference's ``sr_create_model``): a UNet over twice the input channels at
    ``large_size``, conditioned on the bilinear upsampling of the
    ``small_size`` image, in eval mode on ``device``. Its attention takes the
    plain path, as the JAX factory leaves ``use_pallas`` off."""
    from .models.unet import SuperResUNet

    del small_size  # the low-res size comes with the input, as in the JAX factory
    model = SuperResUNet(
        in_channels=cfg.in_channels * 2,
        model_channels=cfg.num_channels,
        out_channels=cfg.out_channels,
        num_res_blocks=cfg.num_res_blocks,
        attention_resolutions=attention_ds(large_size, cfg.attention_resolutions),
        dropout=cfg.dropout,
        channel_mult=channel_mult_for(large_size),
        num_classes=NUM_CLASSES if cfg.class_cond else None,
        num_heads=cfg.num_heads,
        num_heads_upsample=cfg.num_heads_upsample,
        use_scale_shift_norm=cfg.use_scale_shift_norm,
        dtype=cfg.dtype,
    )
    return model.to(device).eval()


def create_diffusion(cfg: Config, eval_mode: bool = False):
    """Build the diffusion process (train: no respacing; eval: respaced)."""
    from .diffusion.process import create_diffusion as _create

    return _create(
        steps=cfg.diffusion_steps,
        learn_sigma=cfg.learn_sigma,
        sigma_small=cfg.sigma_small,
        noise_schedule=cfg.noise_schedule,
        use_kl=cfg.use_kl,
        predict_xstart=cfg.predict_xstart,
        rescale_timesteps=cfg.rescale_timesteps,
        rescale_learned_sigmas=cfg.rescale_learned_sigmas,
        timestep_respacing=cfg.eval_timestep_respacing if eval_mode else cfg.timestep_respacing,
    )


# --------------------------------------------------------------------- #
# Named presets (the reference's shell scripts as data).
# --------------------------------------------------------------------- #
_BASE = Config()

PRESETS = {
    "morphomnist_causaldae": _BASE.replace(
        name="morphomnist_causaldae", dataset="morphomnist", image_size=28, use_bf16=True,
        in_channels=1, n_vars=2, class_cond=True, rep_cond=True,
        causal_modeling=True, masking=True, batch_size=128, total_steps=14000,
    ),
    "morphomnist_diffae": _BASE.replace(
        name="morphomnist_diffae", dataset="morphomnist", image_size=28, use_bf16=True,
        in_channels=1, n_vars=2, class_cond=True, rep_cond=True,
        batch_size=128, total_steps=6000,
    ),
    "morphomnist_conditional": _BASE.replace(
        name="morphomnist_conditional", dataset="morphomnist", image_size=28, use_bf16=True,
        in_channels=1, n_vars=2, class_cond=True, context_cond=True,
        batch_size=128, total_steps=6000,
    ),
    "pendulum_causaldae": _BASE.replace(
        name="pendulum_causaldae", dataset="pendulum", image_size=96, use_bf16=True,
        in_channels=4, n_vars=4, rep_dim=64, rep_cond=True,
        causal_modeling=True, masking=True, batch_size=32, total_steps=35000,
    ),
    "pendulum_diffae": _BASE.replace(
        name="pendulum_diffae", dataset="pendulum", image_size=96, use_bf16=True,
        in_channels=4, n_vars=4, rep_dim=64, rep_cond=True,
        batch_size=32, total_steps=50000,
    ),
    "pendulum_conditional": _BASE.replace(
        name="pendulum_conditional", dataset="pendulum", image_size=96, use_bf16=True,
        in_channels=4, context_cond=True, batch_size=32, total_steps=35000,
    ),
    "circuit_causaldae": _BASE.replace(
        name="circuit_causaldae", dataset="circuit", image_size=128,
        in_channels=3, n_vars=4, rep_cond=True, causal_modeling=True,
        masking=True, diffusion_steps=2000, batch_size=16, total_steps=20000,
        use_bf16=True,
    ),
    "circuit_diffae": _BASE.replace(
        name="circuit_diffae", dataset="circuit", image_size=128,
        in_channels=3, n_vars=4, rep_cond=True, diffusion_steps=2000,
        batch_size=16, total_steps=20000, use_bf16=True,
    ),
    "circuit_conditional": _BASE.replace(
        name="circuit_conditional", dataset="circuit", image_size=128,
        in_channels=3, context_cond=True, diffusion_steps=2000,
        batch_size=16, total_steps=45000, use_bf16=True,
    ),
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
