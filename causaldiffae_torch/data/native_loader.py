"""ctypes bindings for the native C++ data-pipeline core.

Port of ``causaldiffae_tpu/data/native_loader.py``. Builds the package's own
copy of the loader, ``causaldiffae_torch/native/fastloader.cpp``, with g++ at
first use into ``build/causaldiffae_torch/`` beside the package (the
directory the CUDA kernels build into), named after a hash of the source and
the flags, so an edited source is rebuilt; and exposes:

- ``gunzip_file``: zlib whole-file decompression (IDX archives);
- ``gather_normalize``: a multithreaded batch gather with the uint8 ->
  float32 normalisation fused;
- ``NativeBatchIterator``: a double-buffered prefetch loader: the next
  shuffled, normalised batch is assembled on C++ worker threads while the
  device runs the current step.

Host code, not a device path: where no compiler builds it
(``native_available()`` false), the first two fall back to numpy and
``data.loaders.make_data_iterator`` to the numpy ``batch_iterator``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["native_available", "gunzip_file", "gather_normalize", "NativeBatchIterator"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "causaldiffae_torch"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
LIBS = ["-lz", "-lpthread"]
_LIB = None
_LIB_ERR = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastloader-{digest}.so"


def _build_and_load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        so = _lib_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.fl_gunzip_file.restype = ctypes.c_int
        lib.fl_gunzip_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fl_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.fl_gather_u8_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fl_loader_create.restype = ctypes.c_void_p
        lib.fl_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.fl_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.fl_loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception as e:  # noqa: BLE001 - no compiler or zlib: the numpy paths serve
        _LIB_ERR = e
    return _LIB


def native_available() -> bool:
    return _build_and_load() is not None


def gunzip_file(path: str) -> bytes:
    lib = _build_and_load()
    if lib is None:
        import gzip

        with gzip.open(path, "rb") as f:
            return f.read()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    rc = lib.fl_gunzip_file(str(path).encode(), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"fl_gunzip_file({path}) failed: {rc}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.fl_free(out)


def gather_normalize(images_u8: np.ndarray, indices: np.ndarray,
                     scale: float = 1.0 / 255.0, offset: float = 0.0,
                     threads: int = 4) -> np.ndarray:
    """out[b] = images_u8[indices[b]].astype(f32) * scale + offset."""
    lib = _build_and_load()
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    sample_elems = int(np.prod(images_u8.shape[1:]))
    out = np.empty((len(indices),) + images_u8.shape[1:], dtype=np.float32)
    if lib is None:
        np.multiply(images_u8[indices], np.float32(scale), out=out)
        out += np.float32(offset)
        return out
    lib.fl_gather_u8_to_f32(
        images_u8.ctypes.data, sample_elems, indices.ctypes.data, len(indices),
        scale, offset, out.ctypes.data, threads,
    )
    return out


class NativeBatchIterator:
    """Infinite shuffled batch iterator backed by the C++ prefetch loader.

    Keeps images as uint8 in host RAM (4x smaller than float32) and
    materialises normalised float32 batches on worker threads. Under data
    parallelism the caller passes this rank's ``[rank::W]`` shard.
    """

    def __init__(self, images_u8: np.ndarray, batch_size: int,
                 c: Optional[np.ndarray] = None, y: Optional[np.ndarray] = None,
                 scale: float = 1.0 / 255.0, offset: float = 0.0,
                 seed: int = 0, threads: int = 4):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_LIB_ERR}")
        self._lib = lib
        self.images = np.ascontiguousarray(images_u8, dtype=np.uint8)
        self.c = None if c is None else np.ascontiguousarray(c, dtype=np.float32)
        self.y = None if y is None else np.ascontiguousarray(y, dtype=np.int64)
        self.batch_size = batch_size
        self.sample_shape = self.images.shape[1:]
        sample_elems = int(np.prod(self.sample_shape))
        self._handle = lib.fl_loader_create(
            self.images.ctypes.data, len(self.images), sample_elems,
            None if self.c is None else self.c.ctypes.data,
            0 if self.c is None else self.c.shape[1],
            None if self.y is None else self.y.ctypes.data,
            batch_size, scale, offset, seed, threads,
        )
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        img = np.empty((self.batch_size,) + self.sample_shape, dtype=np.float32)
        cb = None if self.c is None else np.empty(
            (self.batch_size, self.c.shape[1]), dtype=np.float32)
        yb = None if self.y is None else np.empty((self.batch_size,), dtype=np.int64)
        with self._lock:
            self._lib.fl_loader_next(
                self._handle, img.ctypes.data,
                None if cb is None else cb.ctypes.data,
                None if yb is None else yb.ctypes.data,
            )
        out = {"image": img}
        if cb is not None:
            out["c"] = cb
        if yb is not None:
            out["y"] = yb
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.fl_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
