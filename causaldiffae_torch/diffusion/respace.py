"""Timestep respacing (strided sub-sampling of the diffusion process).

The port's own copy of ``causaldiffae_tpu/diffusion/respace.py``. Rebuild of
reference `improved_diffusion/respace.py`. ``space_timesteps`` is
pure host-side Python (same algorithm, `respace.py:7-61`); the respaced
process is represented by a rebuilt :class:`DiffusionSchedule` plus a static
``timestep_map`` array that converts respaced indices to original-process
timesteps before the model sees them (`respace.py:112-124`).
"""

from __future__ import annotations

from typing import Sequence, Set, Tuple, Union

import numpy as np

from .schedule import DiffusionSchedule, make_schedule

__all__ = ["space_timesteps", "respace_schedule"]


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Pick a subset of original timesteps (reference `respace.py:7-61`).

    ``section_counts`` is a list of per-section step counts, a comma-separated
    string, or ``"ddimN"`` for the fixed DDIM striding.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def respace_schedule(
    base_betas: np.ndarray, use_timesteps: Set[int]
) -> Tuple[DiffusionSchedule, np.ndarray]:
    """Rebuild betas for the kept timesteps from the base alphas_cumprod.

    Returns ``(respaced_schedule, timestep_map)`` where ``timestep_map[i]`` is
    the original-process timestep of respaced step ``i`` (sorted ascending).
    Mirrors reference `respace.py:74-88`: the kept steps' cumulative alpha
    products are preserved exactly, so q(x_t | x_0) at a kept step is
    identical in the respaced and original processes.
    """
    base = make_schedule(np.asarray(base_betas, dtype=np.float64))
    # Recompute alphas_cumprod in float64 to avoid compounding float32 error.
    alphas_cumprod = np.cumprod(1.0 - np.asarray(base_betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, ac in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - ac / last_alpha_cumprod)
            last_alpha_cumprod = ac
            timestep_map.append(i)
    del base
    return make_schedule(np.array(new_betas)), np.array(timestep_map, dtype=np.int32)
