"""Data parallelism of the port: 2 gloo ranks on the CPU against one process.

Two worker processes (this file run as a script; they import no JAX) join a
gloo group through ``init_method=file://`` in a temporary directory, as
``tests/test_multihost.py`` starts its workers, and run every case once; the
test process computes the one-process references meanwhile. W ranks at
global batch B must take the step one process at B takes: the same global
draws from the (seed, step) generator, each rank its ``rank_rows``, every
batch reduction global.

Cases, on the flagship's tiny config (``masking=True``, B = 8, 4 rows per
rank, every weight filled from a seed, fp32), 2 steps each: the plain step
(global BatchNorm statistics and the global masked KL); ``flow_based`` (the
flow's -mean(log_det) over the global batch, ``masking=False``); a global
microbatch of 4 (2 rows per rank, the first under ``no_sync``); the
loss-second-moment sampler; a flow built and left unused (DDP's
``find_unused_parameters``). Held to the one process: params, the last
step's gradients, EMA, BatchNorm buffers, the reduced metrics and the
sampler's history, at atol 2e-4, rtol 1e-3 (a gradient: atol 2e-4 of its
tensor's largest entry, never below 1e-3 of the global RMS, as in
``tests/test_torch_train_step.py``); the two ranks bit-equal. The lr is
2e-5, so that the rounding noise an AdamW step turns into +-lr on a
parameter whose true gradient is 0 stays inside atol over 2 steps.

The checks can tell: per-rank BatchNorm statistics and per-rank masked-KL
denominators (each patched into the workers) fall outside that tolerance.

Also: a checkpoint written by rank 0 alone, then a resume on 2 ranks to
step 3, against 3 straight steps of one process; SIGTERM to one rank, on
which both ranks save and stop at the same step; ``counterfactual_test``
on 2 ranks from that checkpoint: both print the same JSON, only rank 0
writes, ``process_count`` is 2, and ``rescore_counterfactuals`` refuses the
archive; ``nll`` and ``sample`` on 2 ranks, each rank its share, the
primary writing the gathered rows.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _port_fixtures import tiny_kwargs

REPO = Path(__file__).resolve().parent.parent
W, B, STEPS = 2, 8, 2
TOL = dict(atol=2e-4, rtol=1e-3)
CASES = {  # name -> config overrides
    "flagship": {},
    "flow": dict(flow_based=True, masking=False),
    "microbatch": dict(microbatch=4),
    "sampler": dict(schedule_sampler="loss-second-moment"),
    "flow_unused": dict(flow_based=True, causal_modeling=False),
    "per_rank_bn": {},
    "per_rank_kl": {},
}
MUTATIONS = ("per_rank_bn", "per_rank_kl")
RESUME_METRICS = ("loss", "mse", "kld_rep", "grad_norm", "param_norm")
CLI_ARGS = ["--synthetic", "--num_samples", "4", "--batch_size", "2", "--clf_epochs", "1",
            "--sampler", "dpm++", "--sample_steps", "3", "--device", "cpu"]


def config(**overrides):
    from causaldiffae_torch.config import Config

    # seed 3: the ranks' keep counts differ in both steps (2 and 3 of 4, then 2 and 1),
    # as they must for per-rank masked-KL denominators to show
    kw = dict(use_bf16=False, use_kernels=False, batch_size=B, lr=2e-5, kl_anneal_steps=2,
              ema_rate="0.9", log_interval=1, save_interval=2, seed=3)
    kw.update(overrides)
    return Config(**tiny_kwargs(**kw))


def build(cfg, seed=0):
    from causaldiffae_torch.config import create_model
    from causaldiffae_torch.utils.weights import fill_normal_

    torch.manual_seed(seed)
    model = create_model(cfg, device="cpu")
    fill_normal_(model, torch.Generator().manual_seed(seed + 1), std=0.05)
    return model


def global_batches(n):
    rng = np.random.RandomState(0)
    return [{"image": (rng.randint(0, 256, (B, 28, 28, 1)) / 255).astype(np.float32),
             "y": rng.randint(0, 10, (B,)).astype(np.int64),
             "c": rng.randn(B, 2).astype(np.float32)} for _ in range(n)]


def local(batches, cfg, rank, world):
    from causaldiffae_torch.parallel import rank_rows

    rows = rank_rows(B, world, rank, cfg.microbatch)
    return [{k: v[rows] for k, v in b.items()} for b in batches]


def snapshot(state, metrics):
    """Every tensor the comparison reads, as numpy, under a kind prefix."""
    out = {}
    for n, p in state.model.named_parameters():
        out[f"param/{n}"] = p.detach().numpy().copy()
        out[f"grad/{n}"] = p.grad.numpy().copy()
    for n, b in state.model.named_buffers():
        if "running" in n:
            out[f"buffer/{n}"] = b.numpy().copy()
    for n, v in next(iter(state.ema.values())).items():
        out[f"ema/{n}"] = v.numpy().copy()
    for k in metrics[0]:
        out[f"metric/{k}"] = np.asarray([m[k] for m in metrics], np.float64)
    if state.sampler_state is not None:
        for k, v in state.sampler_state.items():
            out[f"sampler/{k}"] = np.asarray(v)
    return out


def run_case(name, rank=0, world=1):
    """2 steps of case ``name`` on this rank's rows (one process: all of them)."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.parallel import reduce_metrics
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import wrap_model

    cfg = config(**CASES[name])
    state = create_train_state(cfg, build(cfg))
    state.step = 1  # the KL weight is 1 from here on (kl_anneal_steps=2)
    step = make_train_step(cfg, wrap_model(cfg, state.model, "cpu"), create_diffusion(cfg),
                           state.optimizer)
    metrics = []
    for batch in local(global_batches(STEPS), cfg, rank, world):
        m = reduce_metrics(step(state, {k: torch.from_numpy(v) for k, v in batch.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return snapshot(state, metrics)


def run_resume(ckpt_dir, rank=0, world=1):
    """Steps 1-2 and a checkpoint, then a fresh loop from another init that
    resumes and takes step 3 (one process: 3 straight steps)."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.training import run_training

    cfg = config()
    data = local(global_batches(4), cfg, rank, world)
    kw = dict(log_interval=1, device="cpu")
    if ckpt_dir is None:
        state, recs = run_training(cfg, build(cfg), create_diffusion(cfg), iter(data),
                                   total_steps=3, **kw)
    else:
        run_training(cfg, build(cfg), create_diffusion(cfg), iter(data[:3]), total_steps=2,
                     ckpt_dir=ckpt_dir, **kw)
        state, recs = run_training(cfg, build(cfg, seed=7), create_diffusion(cfg),
                                   iter(data[2:]), total_steps=3, ckpt_dir=ckpt_dir, **kw)
    assert state.step == 3 and recs[-1]["step"] == 3
    return snapshot(state, [{k: recs[-1][k] for k in RESUME_METRICS}])


def run_signal(ckpt_dir, rank, world):
    """SIGTERM reaches rank 1 alone, while it draws the batch after step 1:
    the ranks agree on it through the reduced metrics and both save and stop
    after step 2. Returns (step, the checkpoints' steps)."""
    import signal

    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.training import CheckpointManager, run_training

    cfg = config(save_interval=100)

    def data():
        for i, batch in enumerate(local(global_batches(4), cfg, rank, world)):
            if i == 1 and rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    state, _ = run_training(cfg, build(cfg), create_diffusion(cfg), data(), total_steps=4,
                            log_interval=1, device="cpu", ckpt_dir=ckpt_dir)
    return state.step, CheckpointManager(ckpt_dir).all_steps()


def _worker(rank, world, store, out):
    """One rank: every case, a signal, the checkpoint and resume, and the
    evaluation CLIs."""
    import torch.distributed as dist

    from causaldiffae_torch import counterfactual_test, nll, sample
    from causaldiffae_torch.diffusion import process
    from causaldiffae_torch.models import encoder
    from causaldiffae_torch.training import checkpoint

    rank, world, out = int(rank), int(world), Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    for name in CASES:
        if name == "per_rank_bn":  # each rank's own statistics, as nn.BatchNorm2d would take
            encoder.GaussianConvEncoder.stats_over_ranks = False
        if name == "per_rank_kl":  # each rank's own sum(kld * mask) / sum(mask)
            process.sum_across_ranks = lambda x, group=None: x
        try:
            np.savez(out / f"{name}_{rank}.npz", **run_case(name, rank, world))
        finally:
            encoder.GaussianConvEncoder.stats_over_ranks = True
            process.sum_across_ranks = encoder.sum_across_ranks

    stopped = run_signal(str(out / "signal"), rank, world)
    wrote = []  # what this rank writes: checkpoints, sample archives, grids, probes
    write = checkpoint.CheckpointManager._write
    checkpoint.CheckpointManager._write = lambda self, step, *a: (
        wrote.append(f"step_{step}.pt"), write(self, step, *a))
    np_savez, grid = np.savez, counterfactual_test.save_grid
    np.savez = lambda path, *a, **k: (wrote.append(os.path.basename(path)), np_savez(path, *a, **k))
    counterfactual_test.save_grid = lambda x, path, **k: (wrote.append(os.path.basename(path)),
                                                          grid(x, path, **k))
    save_best = counterfactual_test.ClassifierTrainer.save_best
    counterfactual_test.ClassifierTrainer.save_best = lambda self, path: (
        wrote.append(os.path.basename(path)), save_best(self, path))
    snap = run_resume(str(out / "ckpt"), rank, world)
    np_savez(out / f"resume_{rank}.npz", **snap)
    result = counterfactual_test.main(["--ckpt_dir", str(out / "ckpt"), "--out_dir",
                                       str(out / "eval")] + CLI_ARGS)
    ck = ["--ckpt_dir", str(out / "ckpt"), "--num_samples", "4", "--batch_size", "2",
          "--device", "cpu"]
    total_bpd = nll.main(ck + ["--out_dir", str(out / "nll")])
    path = sample.main(ck + ["--sampler", "dpm++", "--sample_steps", "3", "--out_dir",
                             str(out / "sample")])
    (out / f"cli_{rank}.json").write_text(json.dumps({
        "result": result, "wrote": wrote, "stopped": stopped, "total_bpd": total_bpd,
        "sample_path": path}))
    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "causaldiffae_tpu" not in sys.modules
    print(f"rank {rank}: OK", flush=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two ranks, computes the one-process references meanwhile,
    and returns (output directory, references)."""
    out = tmp_path_factory.mktemp("parallel")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    logs = [open(out / f"rank_{r}.log", "w") for r in range(W)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(W), str(out / "store"),
                               str(out)], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(W)]
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            refs = {name: run_case(name) for name in CASES if name not in MUTATIONS}
            refs["resume"] = run_resume(None)
        finally:
            torch.set_num_threads(n)
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        text = (out / f"rank_{r}.log").read_text()
        assert p.returncode == 0 and f"rank {r}: OK" in text, f"rank {r}:\n{text[-4000:]}"
    return out, refs


def mismatches(got, want):
    """The keys of ``want`` whose arrays in ``got`` fall outside the tolerance."""
    grads = [v for k, v in want.items() if k.startswith("grad/")]
    rms = float(np.sqrt(np.mean(np.concatenate([g.ravel() for g in grads]) ** 2)))
    bad = []
    for k, w in want.items():
        tol = dict(TOL)
        if k.startswith("grad/"):
            tol = dict(rtol=1e-3, atol=max(2e-4 * float(np.abs(w).max()), 1e-3 * rms))
        if not np.allclose(got[k], w, equal_nan=True, **tol):
            bad.append(k)
    return bad


def load_ranks(out, name, same=True):
    """Rank 0's snapshot; with ``same``, rank 1's must be bit-equal to it."""
    ranks = [dict(np.load(out / f"{name}_{r}.npz")) for r in range(W)]
    for k, v in ranks[0].items():  # DDP keeps the replicas bit-equal
        assert not same or v.tobytes() == ranks[1][k].tobytes(), (name, k)
    return ranks[0]


@pytest.mark.parametrize("name", [n for n in CASES if n not in MUTATIONS])
def test_two_ranks_take_the_one_process_step(runs, name):
    out, refs = runs
    got, want = load_ranks(out, name), refs[name]
    assert set(got) == set(want)
    assert mismatches(got, want) == []
    if name == "sampler":  # every rank's (t, loss) pairs pushed, in global order
        assert want["sampler/counts"].sum() == STEPS * B
    if name == "flow":
        assert any(k.startswith("grad/causal_flow.") and np.abs(v).max() > 0
                   for k, v in got.items())


@pytest.mark.parametrize("name", MUTATIONS)
def test_per_rank_reductions_fall_outside_the_tolerance(runs, name):
    """The comparison tells a per-rank BatchNorm or masked KL from the global
    one: the running statistics (or the KL metric) and the gradients move."""
    out, refs = runs
    bad = mismatches(load_ranks(out, name, same=False), refs["flagship"])
    kind = "buffer/" if name == "per_rank_bn" else "metric/kld_rep"
    assert any(k.startswith(kind) for k in bad), bad
    assert any(k.startswith("grad/") for k in bad), bad


def test_checkpoint_by_rank_0_and_resume_on_two_ranks(runs):
    out, refs = runs
    got = load_ranks(out, "resume")
    assert mismatches(got, refs["resume"]) == []
    from causaldiffae_torch.training import CheckpointManager

    assert CheckpointManager(str(out / "ckpt")).all_steps() == [2, 3]
    wrote = [c["wrote"] for c in _cli(out)]
    assert [w for w in wrote[0] if w.startswith("step_")] == ["step_2.pt", "step_3.pt"]
    assert wrote[1] == []  # rank 1 wrote nothing at all, the evaluation's files included


def test_counterfactual_cli_on_two_ranks(runs):
    from causaldiffae_torch import rescore_counterfactuals
    from causaldiffae_torch.utils import logger

    out, _ = runs
    runs_ = _cli(out)
    assert runs_[0]["result"] == runs_[1]["result"]
    result = runs_[0]["result"]
    assert set(result) == {"mae_thickness", "mae_intensity", "clf_val_mse_thickness",
                           "clf_val_mse_intensity"}
    assert all(np.isfinite(v) for v in result.values())
    for name in ("thickness", "intensity"):
        assert f"samples_do_{name}.npz" in runs_[0]["wrote"]
        assert f"classifier_morphomnist_{name}.pkl" in runs_[0]["wrote"]
        with np.load(out / "eval" / f"samples_do_{name}.npz") as z:
            assert int(z["process_count"]) == W
            assert z["samples"].shape == (W * 4, 28, 28, 1)  # both ranks' samples, gathered
    try:
        with pytest.raises(SystemExit, match="process_count"):
            rescore_counterfactuals.main(["--preset", "morphomnist_causaldae",
                                          "--classifier_dir", str(out / "eval"), "--runs",
                                          str(out / "eval"), "--num_samples", "4",
                                          "--batch_size", "2", "--device", "cpu"])
    finally:
        logger.close()


if __name__ == "__main__":
    _worker(*sys.argv[1:])


def _cli(out):
    return [json.loads((out / f"cli_{r}.json").read_text()) for r in range(W)]


def test_a_signal_on_one_rank_stops_both_together(runs):
    out, _ = runs
    assert [c["stopped"] for c in _cli(out)] == [[2, [2]]] * W


def test_nll_and_sample_on_two_ranks(runs):
    """Each rank its ceil(4 / 2) samples; the same total on both ranks (the
    mean of their means); the primary writes the gathered rows."""
    out, _ = runs
    cli = _cli(out)
    assert cli[0]["total_bpd"] == cli[1]["total_bpd"] and np.isfinite(cli[0]["total_bpd"])
    with np.load(out / "nll" / "vb_terms.npz") as z:
        assert z["arr_0"].shape[0] == 4
    assert cli[0]["sample_path"] == cli[1]["sample_path"]
    with np.load(cli[0]["sample_path"]) as z:
        assert z["arr_0"].shape == (4, 28, 28, 1) and np.isfinite(z["arr_0"]).all()
    assert {"vb_terms.npz", "mse_terms.npz", "xstart_mse_terms.npz",
            "samples_4x28x28.npz"} <= set(cli[0]["wrote"])
