"""Serving artifacts, the consumer half: ``causaldiffae_torch.serve_artifact``
(the port of ``scripts/serve.py``'s cases in ``tests/test_serving.py``).

A fresh process that imports torch and ``causaldiffae_torch.serving`` alone
serves an artifact and loads no model code; the CLI pads and trims a
fixed-batch stream, chunks a polymorphic one by ``--batch``, prefers the AOT
package (within 1e-3 of the portable program, fp32), falls back with
``"aot": false`` and a printed reason when the package was built elsewhere,
serves without the pipeline with a p50, and refuses empty input and
``--batch 0``. One AOTInductor compile in the suite (this file's).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _port_fixtures import export, make_checkpoint, one_torch_thread  # noqa: F401
from causaldiffae_torch import serve_artifact, serving

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A fixed-batch (2) reconstruction artifact with its AOT package, and a
    polymorphic one, from one tiny checkpoint."""
    d = tmp_path_factory.mktemp("serve")
    ckpt = make_checkpoint(d / "ckpt")
    fixed, poly = d / "recon_b2.pt2", d / "recon_poly.pt2"
    export(ckpt, fixed, "--fn", "reconstruct", "--batch_size", "2", "--aot", "--verify", "false")
    export(ckpt, poly, "--fn", "reconstruct", "--batch_size", "4", "--poly_batch",
           "--verify", "false")
    return str(fixed), str(poly)


def serve(tmp_path, *argv):
    return serve_artifact.main([*argv, "--out", str(tmp_path / "served.npz")])


def samples(tmp_path):
    return np.load(tmp_path / "served.npz")["samples"]


def test_fresh_process_serves_without_model_code(artifacts, tmp_path):
    """The deployment claim: a process that imports torch and
    ``causaldiffae_torch.serving`` (and the consumer) serves the artifact and
    never loads the models, diffusion, evals or config modules, nor jax."""
    fixed, _ = artifacts
    code = f"""
import json, sys
import torch
import causaldiffae_torch.serving
from causaldiffae_torch import serve_artifact
report = serve_artifact.main(["--artifact", {fixed!r}, "--synthetic", "3", "--no_aot",
                              "--out", {str(tmp_path / "fresh.npz")!r}])
banned = [m for m in sys.modules if m.startswith(("causaldiffae_torch.models",
          "causaldiffae_torch.diffusion", "causaldiffae_torch.evals",
          "causaldiffae_torch.config", "causaldiffae_tpu", "jax"))]
assert not banned, banned
print("FRESH_OK", json.dumps(report))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=str(Path(__file__).resolve().parent.parent))
    assert "FRESH_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    report = json.loads(r.stdout.split("FRESH_OK", 1)[1])
    assert report["served"] == 3 and report["aot"] is False


def test_serve_runs_artifact_over_stream(artifacts, tmp_path):
    """A fixed-batch artifact: the stream's tail padded, then trimmed."""
    fixed, _ = artifacts
    report = serve(tmp_path, "--artifact", fixed, "--synthetic", "5", "--no_aot")
    assert report["served"] == 5 and report["batch"] == 2
    arr = samples(tmp_path)
    assert arr.shape == (5, 28, 28, 1) and np.isfinite(arr).all()


def test_batch_flag_chunks_poly_artifact(artifacts, tmp_path):
    _, poly = artifacts
    report = serve(tmp_path, "--artifact", poly, "--synthetic", "5", "--batch", "2")
    assert report["served"] == 5 and report["batch"] == 2
    assert samples(tmp_path).shape == (5, 28, 28, 1)


def test_aot_package_serves_within_1e3_of_the_portable_program(artifacts, tmp_path):
    """``--aot`` wrote the AOTInductor package; the consumer prefers it
    (``"aot": true``) and answers within 1e-3 of ``--no_aot`` on the same
    seeds (fp32; Inductor fuses and orders sums otherwise)."""
    fixed, _ = artifacts
    record = json.loads(Path(fixed + serving.COMPILED_SUFFIX + ".json").read_text())
    assert record["device_type"] == "cpu" and record["compile_s"] > 0
    r_aot = serve(tmp_path, "--artifact", fixed, "--synthetic", "4", "--prewarm")
    a = samples(tmp_path)
    r_cold = serve(tmp_path, "--artifact", fixed, "--synthetic", "4", "--no_aot")
    b = samples(tmp_path)
    assert r_aot["aot"] is True and r_cold["aot"] is False and "prewarm_s" in r_aot
    assert a.shape == (4, 28, 28, 1) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_mismatched_package_falls_back(artifacts, tmp_path, capsys):
    """A package recorded for another device is refused by
    ``load_compiled_artifact`` and the portable program serves, reported."""
    fixed, _ = artifacts
    odd = tmp_path / "odd.pt2"
    for suffix in ("", ".json"):
        Path(str(odd) + suffix).write_bytes(Path(fixed + suffix).read_bytes())
    Path(str(odd) + serving.COMPILED_SUFFIX).write_bytes(b"not a package")
    Path(str(odd) + serving.COMPILED_SUFFIX + ".json").write_text(
        json.dumps({"device_type": "cuda", "card": "another card", "capability": [8, 0]}))
    with pytest.raises(ValueError):
        serving.load_compiled_artifact(str(odd) + serving.COMPILED_SUFFIX)
    report = serve(tmp_path, "--artifact", str(odd), "--synthetic", "3")
    assert report["aot"] is False and report["served"] == 3
    assert "ignoring" in capsys.readouterr().out


def test_no_pipeline_and_p50(artifacts, tmp_path):
    fixed, _ = artifacts
    report = serve(tmp_path, "--artifact", fixed, "--synthetic", "6", "--no_pipeline", "--no_aot")
    assert report["pipelined"] is False and report["steady_batch_p50_s"] > 0
    assert samples(tmp_path).shape == (6, 28, 28, 1)


def test_rejects_empty_input_and_nonpositive_batch(artifacts, tmp_path):
    fixed, _ = artifacts
    empty = tmp_path / "empty.npz"
    np.savez(empty, x=np.zeros((0, 28, 28, 1), np.float32), y=np.zeros((0,), np.int64))
    with pytest.raises(SystemExit, match="empty"):
        serve(tmp_path, "--artifact", fixed, "--input", str(empty), "--no_aot")
    with pytest.raises(SystemExit, match="must be >= 1"):
        serve(tmp_path, "--artifact", "/nonexistent.pt2", "--batch", "0")
