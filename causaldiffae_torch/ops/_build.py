"""Build a CUDA source in ``csrc/`` with nvcc and load it with ctypes.

A source compiles into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -lcuda -o <lib>.so <src>.cu

(``-lcuda`` for the TMA tensor-map encoder, ``cuTensorMapEncodeTiled``.)

The library goes into ``build/causaldiffae_torch/`` beside the package (a
directory git ignores), named after a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
an unchanged one is loaded as it is. Nothing
builds at import time: the first launch of a kernel builds it, or a caller
builds it ahead with :func:`build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "causaldiffae_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")
    return str(path)


def _lib_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Tuple[float, str]:
    """Compile ``csrc/<name>.cu`` unless its library is up to date.

    Returns the seconds the compile took and what nvcc printed (ptxas
    registers, spills, shared memory); ``(0.0, "")`` for a library already
    built. Raises with nvcc's output when the compile fails.
    """
    lib = _lib_path(name)
    if lib.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
