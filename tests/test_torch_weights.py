"""Weights carried into the port, and the port's isolation from JAX.

- ``state_dict_from_flax`` equals ``export_torch_state_dict`` key for key and
  bitwise on the full ``morphomnist_causaldae`` shapes (flax tree from
  ``jax.eval_shape``, seeded numpy fill: nothing runs at full width), and
  loads into the port's full-width model with ``strict=True``;
- the sources of ``causaldiffae_torch/`` and ``chip_smoke.py`` import no
  jax, flax or causaldiffae_tpu, and importing the package leaves jax out of
  ``sys.modules``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from _port_fixtures import flax_variables
from causaldiffae_tpu.config import get_config as jax_get_config
from causaldiffae_tpu.utils.torch_port import export_torch_state_dict
from causaldiffae_torch.config import create_model, get_config
from causaldiffae_torch.utils.weights import (flatten_variables, state_dict_from_flax,
                                              unflatten_variables)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "causaldiffae_tpu")


def test_state_dict_from_flax_equals_export_on_flagship():
    jax_cfg = jax_get_config("morphomnist_causaldae")
    _, variables = flax_variables(jax_cfg, seed=3)
    want = export_torch_state_dict(jax_cfg, variables)
    cfg = get_config("morphomnist_causaldae")
    got = state_dict_from_flax(cfg, variables)
    assert list(got) == list(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.tobytes() == np.ascontiguousarray(v).tobytes(), k
    model = create_model(cfg, device="cpu")
    model.load_state_dict(got, strict=True)
    assert torch.equal(model.input_blocks[1][1].qkv.weight, got["input_blocks.1.1.qkv.weight"])


def test_load_weights_takes_npz_and_reference_pt(tmp_path):
    """``--init_from``: flax variables as .npz, or a reference-key .pt."""
    from _port_fixtures import configs
    from causaldiffae_torch.utils.weights import load_weights

    jax_cfg, port_cfg = configs(use_bf16=False)
    _, variables = flax_variables(jax_cfg, seed=4)
    npz, pt = tmp_path / "v.npz", tmp_path / "model.pt"
    np.savez(npz, **flatten_variables(variables))
    a = create_model(port_cfg, device="cpu")
    load_weights(port_cfg, a, str(npz))
    torch.save(a.state_dict(), pt)
    b = create_model(port_cfg, device="cpu")
    load_weights(port_cfg, b, str(pt))
    want = state_dict_from_flax(port_cfg, variables)
    for k, v in b.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_npz_variables_roundtrip():
    tree = {"params": {"a": {"kernel": np.arange(6.0).reshape(2, 3)}, "b": np.ones(2)},
            "batch_stats": {"c": {"mean": np.zeros(3)}}}
    back = unflatten_variables(flatten_variables(tree))
    assert back.keys() == tree.keys()
    np.testing.assert_array_equal(back["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
    np.testing.assert_array_equal(back["batch_stats"]["c"]["mean"], np.zeros(3))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "causaldiffae_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, causaldiffae_torch.serve, causaldiffae_torch.evals, "
            "causaldiffae_torch.utils.weights, causaldiffae_torch.train, "
            "causaldiffae_torch.training, causaldiffae_torch.data, "
            "causaldiffae_torch.profile_training; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
