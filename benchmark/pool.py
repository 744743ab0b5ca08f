"""Inputs made from the seed: image pools, labels and draws.

Images sit on the 8-bit grid, as every real source of the three datasets
decodes 8-bit images, so the port's native loader serves them; their content
does not change the work of a step or of a request. Labels are normalised
to [-1, 1]. numpy's PCG64 takes any non-negative seed, and the device draws
come from ``torch.Generator`` seeds split off it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds derived from ``seed``."""
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in np.random.SeedSequence(seed).spawn(n)]


def image_pool(seed: int, n: int, m: dict, signed: bool) -> Dict[str, np.ndarray]:
    """``n`` images (NHWC float32, in [0, 1], or [-1, 1] with ``signed``),
    their labels ``c`` and, for a class-conditional model, classes ``y``."""
    rng = np.random.default_rng(seed)
    s, ch = m["image_size"], m["in_channels"]
    u8 = rng.integers(0, 256, (n, s, s, ch), dtype=np.uint8)
    img = u8.astype(np.float32)
    img = img / np.float32(127.5) - np.float32(1.0) if signed else img / np.float32(255.0)
    out = {"image": img,
           "c": rng.uniform(-1.0, 1.0, (n, m["n_vars"])).astype(np.float32)}
    if m["class_cond"]:
        out["y"] = rng.integers(0, 10, n).astype(np.int64)
    return out
