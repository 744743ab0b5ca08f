"""Serving artifacts: one exported program with the weights inside, and its
AOTInductor package.

Port of ``causaldiffae_tpu/serving.py:32-131``. A counterfactual,
reconstruction or prior chain is traced with ``torch.export`` (the chain as
one ``while_loop`` around one UNet graph, ``diffusion/sampling.py``) and
saved with ``torch.export.save`` into one file whose lifted constants are the
checkpoint's weights, beside a JSON manifest (``<out>.json``). Beside it an
AOTInductor package (``<out>`` + ``COMPILED_SUFFIX``) may hold the same
program compiled for one card. Neither needs the model's code: this module
imports torch and ``causaldiffae_torch.ops`` (which registers the ops an
artifact's graph calls, ``torch.ops.causaldiffae.attention_fwd`` and
``torch.ops.causaldiffae.norm_act_fwd``) and nothing of ``models/``,
``diffusion/``, ``evals/`` or ``config``. A plain-route artifact (exported
with ``use_kernels`` off: manifest ``"attention": "plain"``, ``"norm_nodes":
0``) loads with ``torch.export.load`` alone.

A ``torch.Generator`` cannot live in an exported graph, so the program takes
the chain's draws as inputs after the request's own (``x``, ``y``, ``c``,
``value``); the manifest lists both, each with its shape (``"b"`` for a
symbolic batch) and dtype. :func:`load_artifact` returns the JAX artifact's
call signature, ``fn(x, [y], [c], [value], seed)``: it draws the inputs from
``seed`` on the program's device in the manifest's order, then calls the
program, so one seed gives one answer.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .ops import attention  # registers torch.ops.causaldiffae.attention_fwd
from .ops import norm_act  # registers torch.ops.causaldiffae.norm_act_fwd

__all__ = ["export_artifact", "load_artifact", "export_compiled_artifact",
           "load_compiled_artifact", "attention_nodes", "norm_nodes", "draw_inputs",
           "MANIFEST_SUFFIX", "COMPILED_SUFFIX"]

MANIFEST_SUFFIX = ".json"
COMPILED_SUFFIX = ".aoti.pt2"   # AOTInductor wants a package path ending in .pt2

_DTYPES = {"float32": torch.float32, "int64": torch.int64}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _shape(t: torch.Tensor, batched_dim: Optional[int]) -> List:
    return ["b" if i == batched_dim else int(n) for i, n in enumerate(t.shape)]


def op_nodes(ep, op) -> int:
    """Calls of ``op`` in an exported program's graphs, the loop bodies' included."""
    return sum(1 for gm in ep.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.target is op)


def attention_nodes(ep) -> int:
    """Calls of the attention op in an exported program's graphs."""
    return op_nodes(ep, torch.ops.causaldiffae.attention_fwd.default)


def norm_nodes(ep) -> int:
    """Calls of the norm op in an exported program's graphs."""
    return op_nodes(ep, torch.ops.causaldiffae.norm_act_fwd.default)


def export_artifact(module: torch.nn.Module, example_args: Tuple, out_path: str,
                    manifest: Dict[str, Any], *, names: List[str], draws: List[str],
                    batched_dims: Dict[str, int], poly_batch: bool = False):
    """Export ``module`` at ``example_args`` (the request's inputs ``names``,
    then the draws ``draws``), save the program to ``out_path`` and the
    manifest to ``<out_path>.json``. ``batched_dims`` gives each input's batch
    axis; with ``poly_batch`` that axis is one symbolic size ``b``. Returns
    ``(manifest, exported program)``."""
    import torch.fx.experimental._config as fx_config

    dims = None
    if poly_batch:
        b = torch.export.Dim("b", max=65535)   # the attention kernel's grid, as CUDA's upsampling
        dims = (tuple({batched_dims[n]: b} if n in batched_dims else None
                      for n in names + draws),)   # forward(*args): one tuple
    # no duck sizing: a loop input as long as the example batch (the chain's
    # timesteps when there are as many as rows) would pin b to that size
    with fx_config.patch(use_duck_shape=False):
        ep = torch.export.export(module, tuple(example_args), dynamic_shapes=dims)
    for gm in ep.graph_module.modules():   # the traces' Python stacks: 99% of the file
        if isinstance(gm, torch.fx.GraphModule):
            for n in gm.graph.nodes:
                n.meta.pop("stack_trace", None)
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, str(p))

    def spec(name, t):
        return {"name": name, "shape": _shape(t, batched_dims.get(name) if poly_batch else None),
                "dtype": _dtype_name(t.dtype)}

    specs = [spec(n, t) for n, t in zip(names + draws, example_args)]
    # the output's shape and dtype from the graph's fake value
    fake = next(n for n in ep.graph.nodes if n.op == "output").args[0][0].meta["val"]
    manifest = dict(manifest)
    n_attn = attention_nodes(ep)
    manifest.update({
        "device": example_args[0].device.type,
        "inputs": specs[:len(names)] + [{"name": "seed", "shape": [], "dtype": "int64"}],
        "draws": specs[len(names):],
        "outputs": [{"shape": ["b" if poly_batch and i == 0 else int(n)
                               for i, n in enumerate(fake.shape)],
                     "dtype": _dtype_name(fake.dtype)}],
        "attention": "kernel" if n_attn else "plain",
        "attention_nodes": n_attn,
        "norm_nodes": norm_nodes(ep),
        "bytes": p.stat().st_size,
    })
    Path(str(p) + MANIFEST_SUFFIX).write_text(json.dumps(manifest, indent=2))
    return manifest, ep


def _links_openmp(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o", str(Path(d) / "a.out")],
                           input="int main() { return 0; }", capture_output=True, text=True)
    return r.returncode == 0


def _host_compiler() -> str:
    """The C++ compiler for the package's host code. Inductor takes ``$CXX``
    (else ``g++``) and links with ``-fopenmp``; a compiler whose installation
    lacks OpenMP's spec file fails that link, so the first of ``$CXX`` and
    the ``g++`` and ``c++`` on ``PATH`` that links an OpenMP program is taken."""
    tried = []
    for cxx in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cxx and cxx not in tried:
            tried.append(cxx)
            if _links_openmp(cxx):
                return cxx
    raise RuntimeError(f"no C++ compiler links an OpenMP program (tried {tried}); "
                       "AOTInductor's host code needs one")


def export_compiled_artifact(ep, out_path: str) -> Dict[str, Any]:
    """Compile the exported program with AOTInductor into the package
    ``out_path`` (the artifact's path + ``COMPILED_SUFFIX``), and record what
    it was built for beside it (``<out_path>.json``: device type, card, its
    compute capability, torch version, host compiler, compile seconds).
    Returns that record."""
    import time

    import torch._inductor.config as inductor_config

    cxx = _host_compiler()
    t0 = time.perf_counter()
    # emulate_precision_casts: round each bf16 intermediate as the eager program
    # does. allow_buffer_reuse off: in PyTorch 2.11 the reuse planner's peak
    # estimate indexes past its range inside a while_loop body and aborts the
    # compile (segmented_tree.summarize_range); the package then keeps each
    # intermediate buffer of its own.
    with inductor_config.patch({"cpp.cxx": (None, cxx), "emulate_precision_casts": True,
                                "allow_buffer_reuse": False}):
        torch._inductor.aoti_compile_and_package(ep, package_path=str(out_path))
    record = {"compile_s": time.perf_counter() - t0, "cxx": cxx, **_device_record(ep)}
    record["bytes"] = Path(out_path).stat().st_size
    Path(str(out_path) + MANIFEST_SUFFIX).write_text(json.dumps(record, indent=2))
    return record


def _device_record(ep=None) -> Dict[str, Any]:
    """What a compiled package is tied to: the device type, and on a card its
    name and compute capability; the torch version."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if ep is not None:
        dev = next((t.device for t in ep.state_dict.values()), dev)
    rec = {"device_type": dev.type, "torch": torch.__version__}
    if dev.type == "cuda":
        rec["card"] = torch.cuda.get_device_name(dev)
        rec["capability"] = list(torch.cuda.get_device_capability(dev))
    return rec


def load_compiled_artifact(path: str) -> Callable:
    """Load an AOTInductor package; raises ``ValueError`` when it was built
    for another device type, card or torch (its record says which), or has no
    record. The caller then serves the portable program."""
    rec_path = Path(str(path) + MANIFEST_SUFFIX)
    if not rec_path.exists():
        raise ValueError(f"{path}: no record of the device it was compiled for ({rec_path})")
    built = json.loads(rec_path.read_text())
    if built.get("device_type") == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"{path} was compiled for {built.get('card')}; no CUDA device here")
    here = _device_record()
    for key in ("device_type", "card", "capability", "torch"):
        if built.get(key) != here.get(key):
            raise ValueError(f"{path} was compiled for {key} {built.get(key)!r}; "
                             f"this process has {here.get(key)!r}")
    return torch._inductor.aoti_load_package(str(path))


def draw_inputs(manifest: Dict[str, Any], batch: int, seed: int, device) -> List[torch.Tensor]:
    """The program's draws for ``batch`` rows, from ``seed``, in the
    manifest's order: each a standard normal of its shape (``"b"`` is the
    batch), drawn by one ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for d in manifest["draws"]:
        shape = [batch if s == "b" else s for s in d["shape"]]
        out.append(torch.randn(shape, generator=gen, device=device, dtype=_DTYPES[d["dtype"]]))
    return out


def load_artifact(path: str, program: Optional[Callable] = None) -> Tuple[Callable, Dict]:
    """``(fn, manifest)`` for the artifact at ``path``: ``fn(x, [y], [c],
    [value], seed)`` per ``manifest['inputs']`` (tensors or arrays), which
    draws the program's other inputs from ``seed`` and returns its output.
    ``program`` replaces the portable program (an AOTInductor package from
    :func:`load_compiled_artifact`)."""
    manifest = json.loads(Path(str(path) + MANIFEST_SUFFIX).read_text())
    if program is None:
        program = torch.export.load(str(path)).module()
    device = torch.device(manifest["device"])
    specs = manifest["inputs"][:-1]   # the last is the seed

    def fn(*args):
        if len(args) != len(specs) + 1:
            raise TypeError(f"the artifact takes {[s['name'] for s in manifest['inputs']]}, "
                            f"got {len(args)} arguments")
        inputs = [torch.as_tensor(a, dtype=_DTYPES[s["dtype"]], device=device)
                  for a, s in zip(args, specs)]
        batch = next((t.shape[0] for t, s in zip(inputs, specs) if s["shape"]), None)
        if batch is None:   # the prior: the batch of its draws
            batch = next(d["shape"][0] for d in manifest["draws"])
        with torch.no_grad():
            return program(*inputs, *draw_inputs(manifest, batch, args[-1], device))

    return fn, manifest
