"""What an intervention asks and what the true SCM answers, for the eval CLIs.

The port's own copy of ``VAR_NAMES``, ``INTERVENTION_RANGES`` and
``ground_truth_factors`` (``scripts/counterfactual_test.py:31-69``), built on
the port's simulators, and :func:`intervention_plan`, the random draws of an
effectiveness evaluation in the order the JAX CLI consumes its
``RandomState(seed)``. The evaluation CLI and the rescoring CLI both take
their requests and ground truth from it, so a rescore replays the run it
scores, and both replay a JAX run with the same seed and pool.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from .config import DATA_SCALES
from .data.simulators import circuit_scm, morphomnist_scm, pendulum_scm

__all__ = ["VAR_NAMES", "INTERVENTION_RANGES", "ground_truth_factors", "Intervention",
           "intervention_plan"]

# variable names per dataset, in latent block order
VAR_NAMES = {
    "morphomnist": ["thickness", "intensity"],
    "pendulum": ["angle", "light", "shadow_len", "shadow_pos"],
    "circuit": ["arm", "blue", "green", "red"],
}
# raw intervention ranges (dataset units) per variable; the pendulum's
# effect variables take the reference's sweep ranges (uniform(3, 9) and
# uniform(3, 15), `image_causaldae_test.py:541-542`)
INTERVENTION_RANGES = {
    "morphomnist": [(1.0, 5.5), (64, 250)],
    "pendulum": [(-40, 44), (60, 148), (3, 9), (3, 15)],
    "circuit": [(0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0)],
}


def ground_truth_factors(dataset: str, c_raw: np.ndarray, var_idx: int, value) -> np.ndarray:
    """Propagate do(var = value) through the ground-truth SCM -> all factors (raw units)."""
    c_new = np.array(c_raw, dtype=np.float64)
    c_new[:, var_idx] = value
    if dataset == "morphomnist":
        if var_idx == 0:  # thickness -> intensity
            c_new[:, 1] = morphomnist_scm(c_new[:, 0])
        return c_new
    if dataset == "pendulum":
        if var_idx in (0, 1):
            slen, spos = pendulum_scm(c_new[:, 0], c_new[:, 1])
            c_new[:, 2], c_new[:, 3] = slen, spos
        return c_new
    if dataset == "circuit":
        if var_idx == 0:
            b, g, r = circuit_scm(c_new[:, 0])
            c_new[:, 1], c_new[:, 2], c_new[:, 3] = b, g, r
        return c_new
    raise ValueError(dataset)


class Intervention(NamedTuple):
    """One batch of requests: pool rows, do() value raw and normalised, and
    the normalised ground truth of every factor ``[batch, n_factors]``."""
    sel: np.ndarray
    raw_value: float
    value: float
    gt_norm: np.ndarray


def intervention_plan(dataset: str, c_pool: np.ndarray, *, seed: int, batch_size: int,
                      n_batches: int) -> Tuple[np.ndarray, List[List[Intervention]]]:
    """(probe_sel, plan[var][batch]) drawn from ``RandomState(seed)``: first
    the probe batch's rows (reconstruction and traversal grids), then per
    variable in order and per batch the request rows (randint) and the raw
    value (uniform) -- the JAX CLI's single-process stream. ``c_pool`` is the
    test pool's normalised labels."""
    scale = np.asarray(DATA_SCALES[dataset])
    rng = np.random.RandomState(seed)
    n = len(c_pool)
    probe_sel = rng.randint(0, n, batch_size)
    plan = []
    for var_idx, rng_range in enumerate(INTERVENTION_RANGES[dataset]):
        batches = []
        for _ in range(n_batches):
            sel = rng.randint(0, n, batch_size)
            raw_value = rng.uniform(*rng_range)
            c_raw = c_pool[sel] * scale[:, 1] + scale[:, 0]
            gt = ground_truth_factors(dataset, c_raw, var_idx, raw_value)
            batches.append(Intervention(
                sel, raw_value, (raw_value - scale[var_idx, 0]) / scale[var_idx, 1],
                (gt - scale[:, 0]) / scale[:, 1]))
        plan.append(batches)
    return probe_sel, plan
