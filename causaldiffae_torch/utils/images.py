"""Image grids as PNG files, with the standard library only (zlib, struct).

The port's ``save_grid``: the layout, clipping and uint8 conversion of
``scripts/counterfactual_test.py:72-88``, which writes through PIL; the
card's machine has no PIL, so the PNG is encoded here: 8-bit greyscale, RGB
or RGBA, one unfiltered scanline per row, one zlib-compressed IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["save_grid", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> greyscale, RGB, RGBA


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write uint8 ``[H, W]`` or ``[H, W, C]`` (C in 1, 3, 4) as a PNG file."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(arr))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
                + _chunk(b"IEND", b""))


def save_grid(images: np.ndarray, path: str, ncol: int = 8) -> None:
    """NHWC images in [0, 1] as one PNG grid, ``ncol`` per row, row-major."""
    imgs = np.asarray(images)
    n, h, w, c = imgs.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros((nrow * h, ncol * w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    write_png(path, (np.clip(grid, 0, 1) * 255).astype(np.uint8))
