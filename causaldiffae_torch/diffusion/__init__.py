"""Diffusion process, schedules and sampling chains (serving subset)."""

from .process import GaussianDiffusion, create_diffusion
from .respace import respace_schedule, space_timesteps
from .sampling import (
    ddim_reverse_loop,
    ddim_sample_loop,
    dpm_solver_pp_loop,
    p_sample_loop,
)
from .schedule import DiffusionSchedule, get_named_beta_schedule, make_schedule

__all__ = [
    "GaussianDiffusion",
    "create_diffusion",
    "respace_schedule",
    "space_timesteps",
    "ddim_reverse_loop",
    "ddim_sample_loop",
    "dpm_solver_pp_loop",
    "p_sample_loop",
    "DiffusionSchedule",
    "get_named_beta_schedule",
    "make_schedule",
]
