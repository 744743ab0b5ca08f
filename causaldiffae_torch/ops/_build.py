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
builds it ahead with :func:`build`. What nvcc printed is kept beside the
library (``<lib>.log``), and :func:`ptxas_report` reads it: one record per
kernel instantiation with its registers, spills, shared memory and whether
ptxas serialized its wgmmas.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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

    Returns the seconds the compile took (0.0 for a library already built)
    and what nvcc printed when it built it (ptxas registers, spills, shared
    memory). Raises with nvcc's output when the compile fails.
    """
    lib = _lib_path(name)
    log = lib.with_suffix(".log")
    if lib.exists():
        return 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, lib)
    return time.perf_counter() - t0, proc.stdout


def _demangle(mangled: str) -> Tuple[str, Optional[int]]:
    """``(name, D)`` of a kernel's mangled name: the nested name with its
    integer template argument, as ``cdae::(anonymous namespace)::k<128>``
    and 128. A name outside that pattern comes back as it is, with None."""
    parts, i = [], 3
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        ident = mangled[i + len(n):i + len(n) + int(n)]
        parts.append("(anonymous namespace)" if ident.startswith("_GLOBAL__N") else ident)
        i += len(n) + int(n)
    m = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[i:])
    args = [int(a) for a in re.findall(r"L[ib](-?\d+)E", m.group(1))] if m else []
    if not parts or not mangled[i + (m.end() if m else 0):].startswith("E"):
        return mangled, None
    name = "::".join(parts) + (f"<{', '.join(map(str, args))}>" if args else "")
    return name, (args[0] if args else None)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SERIAL = re.compile(r"wgmma\.mma_async instructions are serialized(?: due to (.*?))?"
                     r"(?: (?:in|for) the function '([^']+)')?\.?\s*$")


def ptxas_report(log: str) -> List[dict]:
    """One record per kernel instantiation from nvcc's ``-Xptxas -v`` output.

    Each record: ``name`` (demangled), ``kernel`` (its last component, no
    template arguments), ``d`` (its integer template argument, the head
    width), ``registers``, ``spill_stores`` and ``spill_loads`` (bytes),
    ``stack`` (bytes), ``smem_static`` (bytes; the dynamic shared memory is
    set at launch and is not in the log), ``wgmma_serialized`` and
    ``serialized_reason`` (ptxas's C7515 note that the kernel's wgmmas
    wait on each other, and why). Records come in the log's order.
    """
    records: Dict[str, dict] = {}
    serialized: Dict[str, Optional[str]] = {}  # ptxas may note it before the kernel's entry
    current = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            name, d = _demangle(current)
            records[current] = {"name": name, "kernel": name.split("::")[-1].split("<")[0],
                                "d": d, "registers": None, "spill_stores": 0,
                                "spill_loads": 0, "stack": 0, "smem_static": 0,
                                "wgmma_serialized": False, "serialized_reason": None}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and props in records:
            rec = records[props]
            rec["stack"], rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
            continue
        m = _SERIAL.search(line)
        if m:
            serialized[m.group(2) or current] = m.group(1)
            continue
        m = _USED.search(line)
        if m and current in records:
            records[current]["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            records[current]["smem_static"] = int(s.group(1)) if s else 0
    for mangled, reason in serialized.items():
        if mangled in records:
            records[mangled].update(wgmma_serialized=True, serialized_reason=reason)
    return list(records.values())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
