"""Serving artifacts, the producer half: ``causaldiffae_torch.export_serving``
and ``serving.load_artifact`` (the port of ``tests/test_serving.py``'s
export cases), and the chains' traceable form.

- each chain's traceable form (``while_loop``), run through
  ``torch.export``, is bit-equal to its eager loop in fp32 and held to the
  JAX chain from an injected x_t;
- the counterfactual artifact's manifest, seed determinism and sensitivity,
  and its answer bit-equal to ``make_counterfactual_fn`` on the same draws
  (that function is held to the JAX package in ``test_torch_serving.py``);
- the prior artifact takes no x; a polymorphic artifact serves batches 1
  and 3; a bf16 ``use_kernels`` export holds the attention op and one norm
  op per GroupNorm32 (the plain versions on the CPU); a plain-route artifact
  holds neither and loads with torch alone.

Tiny fp32 model from a checkpoint; tolerances as stated per test.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _port_fixtures import export, make_checkpoint, one_torch_thread, tiny_kwargs  # noqa: F401
from causaldiffae_tpu.diffusion import create_diffusion as jax_create_diffusion
from causaldiffae_tpu.diffusion import sampling as jax_sampling
from causaldiffae_torch import serving
from causaldiffae_torch.diffusion import create_diffusion, sampling
from causaldiffae_torch.ops.attention import attention_fwd

F32_TOL = dict(atol=2e-4, rtol=1e-3)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("export") / "ckpt")


@pytest.fixture(scope="module")
def counterfactual(ckpt, tmp_path_factory):
    out = tmp_path_factory.mktemp("cf") / "do0.pt2"   # the plain route: torch alone loads it
    manifest = export(ckpt, out, "--fn", "counterfactual", "--intervene_var", "0",
                      "--batch_size", "4", "--use_kernels", "false")
    return str(out), manifest


def test_attention_op_registration():
    """The forward is a dispatcher op whose fake tensor export can trace
    (``torch.library.opcheck``: schema, fake, dispatch); a call that needs no
    gradient goes through it, one that does through ``FusedAttention``, and
    on the CPU both give the plain version."""
    from causaldiffae_torch.ops import attention as ops

    qkv = torch.randn(2, 10, 3 * 64).to(torch.bfloat16)
    torch.library.opcheck(torch.ops.causaldiffae.attention_fwd.default, (qkv, 2))
    want = ops.attention_plain(qkv, 2)
    with torch.no_grad():
        torch.testing.assert_close(ops.fused_qkv_attention(qkv, 2), want, atol=0, rtol=0)
    g = qkv.clone().requires_grad_(True)
    out = ops.fused_qkv_attention_t(g, 2)
    assert out.grad_fn is not None and "FusedAttention" in type(out.grad_fn).__name__
    torch.testing.assert_close(out.detach(), want, atol=0, rtol=0)


# --------------------------------------------------------------------- #
def _eps_jax(x, t):
    return jnp.tanh(x) * jnp.cos(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1)


def _eps_torch(x, t):
    return torch.tanh(x) * torch.cos(t.float() / 100.0).reshape(-1, 1, 1, 1)


class _Chain(torch.nn.Module):
    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, *args):
        return self.run(*args)


@pytest.mark.parametrize("chain", ["ddim", "ddpm", "dpm++", "ddim_reverse"])
def test_traceable_chain_equals_eager_and_jax(chain):
    """The exported chain is bit-equal to the eager loop, and both are within
    fp32 tolerance of the JAX chain from the same x_t (DDPM: the JAX chain's
    own step draws, rebuilt from its key and handed over)."""
    ours = create_diffusion(steps=100, timestep_respacing="10")
    theirs = jax_create_diffusion(steps=100, timestep_respacing="10")
    x_t = np.random.RandomState(1).randn(3, 8, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    args = (torch.from_numpy(x_t),)
    if chain == "ddim":
        run = lambda x, tr: sampling.ddim_sample_loop(ours, _eps_torch, x, traceable=tr)  # noqa: E731
        want = jax_sampling.ddim_sample_loop(theirs, _eps_jax, jnp.asarray(x_t), key)
    elif chain == "dpm++":
        run = lambda x, tr: sampling.dpm_solver_pp_loop(ours, _eps_torch, x, num_steps=6,  # noqa: E731
                                                        traceable=tr)
        want = jax_sampling.dpm_solver_pp_loop(theirs, _eps_jax, jnp.asarray(x_t), num_steps=6)
    elif chain == "ddim_reverse":
        run = lambda x, tr: sampling.ddim_reverse_loop(ours, _eps_torch, x, traceable=tr)  # noqa: E731
        want = jax_sampling.ddim_reverse_loop(theirs, _eps_jax, jnp.asarray(x_t))
    else:
        draws, k = [], key
        for _ in range(ours.num_timesteps):   # p_sample_loop's key schedule
            k, sub = jax.random.split(k)
            draws.append(np.asarray(jax.random.normal(sub, x_t.shape, jnp.float32)))
        args += (torch.from_numpy(np.stack(draws)),)
        run = lambda x, n, tr: sampling.p_sample_loop(ours, _eps_torch, x, step_noise=n,  # noqa: E731
                                                      traceable=tr)
        want = jax_sampling.p_sample_loop(theirs, _eps_jax, jnp.asarray(x_t), key)
    ours.arrays_on("cpu")
    program = torch.export.export(_Chain(lambda *a: run(*a, True)), args).module()
    got = program(*args)
    eager = run(*args, False)
    torch.testing.assert_close(got, eager, atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_counterfactual_artifact_roundtrip(counterfactual):
    """The CLI's --verify held the artifact to the direct call; the manifest
    and the artifact alone: seed determinism and sensitivity."""
    out, manifest = counterfactual
    saved = json.loads(Path(out + ".json").read_text())
    assert [i["name"] for i in saved["inputs"]] == ["x", "y", "value", "seed"]
    assert [d["name"] for d in saved["draws"]] == ["rep_noise", "abduction_noise"]
    assert saved["outputs"][0]["shape"] == [4, 28, 28, 1]
    assert saved["attention"] == "plain" and saved["device"] == "cpu"
    assert saved["norm_nodes"] == 0   # the plain chain: the artifact loads with torch alone
    assert manifest["verify"][0]["max_abs"] <= manifest["verify"][0]["atol"]
    fn, _ = serving.load_artifact(out)
    x = torch.zeros(4, 28, 28, 1)
    y = torch.zeros(4, dtype=torch.long)
    a, b, c = fn(x, y, 1.0, 3), fn(x, y, 1.0, 3), fn(x, y, 1.0, 4)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert float((a - c).abs().max()) > 0 and bool(torch.isfinite(a).all())


def test_artifact_equals_make_counterfactual_fn(counterfactual, ckpt):
    """On the CPU the exported counterfactual gives ``make_counterfactual_fn``'s
    answer bit for bit, on the same request and draws."""
    from causaldiffae_torch.config import create_diffusion as create_diff
    from causaldiffae_torch.evals import make_counterfactual_fn
    from causaldiffae_torch.serve import load_checkpoint

    out, manifest = counterfactual
    cfg, model, _ = load_checkpoint(ckpt, use_ema=False, device="cpu")
    rng = np.random.RandomState(2)
    x = torch.from_numpy(np.clip(rng.randn(4, 28, 28, 1) * 0.5, -1, 1).astype(np.float32))
    y = torch.tensor([1, 3, 5, 7])
    rep_noise, abduction_noise = serving.draw_inputs(manifest, 4, 11, "cpu")
    want = make_counterfactual_fn(cfg, model, create_diff(cfg, eval_mode=True),
                                  intervene_var=0)(x, {"y": y}, 0.7, rep_noise=rep_noise,
                                                   abduction_noise=abduction_noise)
    got = serving.load_artifact(out)[0](x, y, 0.7, 11)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_prior_artifact_needs_no_x(ckpt, tmp_path):
    out = tmp_path / "prior.pt2"
    export(ckpt, out, "--fn", "prior", "--batch_size", "2", "--sampler", "dpm++",
           "--sample_steps", "3")
    fn, manifest = serving.load_artifact(str(out))
    assert [i["name"] for i in manifest["inputs"]] == ["y", "seed"]
    assert [d["name"] for d in manifest["draws"]] == ["z", "x_T"]
    imgs = fn(torch.zeros(2, dtype=torch.long), 0)
    assert imgs.shape == (2, 28, 28, 1) and bool(torch.isfinite(imgs).all())


def test_poly_batch_artifact_serves_any_batch(ckpt, tmp_path):
    """--poly_batch: one artifact for every batch size (--verify checked 2
    and 4 against the direct call); batches 1 and 3 here."""
    out = tmp_path / "recon_poly.pt2"
    manifest = export(ckpt, out, "--fn", "reconstruct", "--batch_size", "4", "--poly_batch")
    assert manifest["batch_size"] == "polymorphic"
    assert manifest["inputs"][0]["shape"][0] == "b"
    assert [v["batch"] for v in manifest["verify"]] == [2, 4]
    fn, _ = serving.load_artifact(str(out))
    for b in (1, 3):
        imgs = fn(torch.zeros(b, 28, 28, 1), torch.zeros(b, dtype=torch.long), 0)
        assert imgs.shape == (b, 28, 28, 1) and bool(torch.isfinite(imgs).all())


def test_kernel_route_export_holds_the_attention_op(tmp_path):
    """A bf16 ``use_kernels`` model exports with one ``causaldiffae::attention_fwd``
    node per attention block (in the chain's loop body); on the CPU the op
    runs the plain version, which launches nothing."""
    ck = make_checkpoint(tmp_path / "ck", use_bf16=True)
    out = tmp_path / "bf16.pt2"
    launches = attention_fwd.launches
    manifest = export(ck, out, "--fn", "reconstruct", "--batch_size", "2",
                      "--sampler", "dpm++", "--sample_steps", "3")
    assert manifest["attention"] == "kernel" and manifest["attention_nodes"] == 4
    assert manifest["verify"][0]["max_abs"] == 0.0
    ep = torch.export.load(str(out))
    assert serving.attention_nodes(ep) == 4
    assert attention_fwd.launches == launches
    # each GroupNorm32 of the UNet's one graph is one norm node
    from causaldiffae_torch.config import Config, create_model
    from causaldiffae_torch.models import GroupNorm32

    model = create_model(Config(**tiny_kwargs(use_bf16=True)), device="cpu")
    norms = sum(isinstance(m, GroupNorm32) for m in model.modules())
    assert manifest["norm_nodes"] == serving.norm_nodes(ep) == norms > 0


def test_plain_artifact_loads_with_torch_alone(counterfactual):
    """A plain-route artifact needs only torch: a fresh process that imports
    nothing of this repository loads and runs it."""
    out, _ = counterfactual
    code = f"""
import sys
import torch
prog = torch.export.load({out!r}).module()
args = [torch.zeros(4, 28, 28, 1), torch.zeros(4, dtype=torch.long), torch.tensor(1.0),
        torch.randn(4, 32), torch.randn(4, 28, 28, 1)]
with torch.no_grad():
    imgs = prog(*args)
assert imgs.shape == (4, 28, 28, 1) and bool(torch.isfinite(imgs).all())
assert not any(m.startswith(("causaldiffae", "jax")) for m in sys.modules), sorted(sys.modules)
print("BARE_LOAD_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=str(Path(out).parent))
    assert "BARE_LOAD_OK" in r.stdout, r.stderr[-3000:]
