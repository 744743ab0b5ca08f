"""The port's runtime: logger, event writer, checkpoints, the train loop.

- the logger's keys, means and files (CSV header growth included) equal to
  the JAX logger's, and a resumed CSV that keeps its header;
- the TensorBoard event file byte for byte equal to the JAX writer's;
- a checkpoint round trip (every tensor and the step bit-equal), keep-3 and
  latest-step discovery;
- resume equality: 6 steps straight equal 3 steps, a save, a fresh loop
  that resumes and 3 more, on the same batches: parameters, AdamW moments,
  EMA copies, BatchNorm buffers and the sampler's history bit-equal;
- SIGTERM sent from inside the data iterator: a checkpoint at that step and
  the old handler back; the ``DIFFUSION_TRAINING_TEST`` early exit;
- the train CLI on the CPU for a tiny 4-variable config without classes,
  with ``--ckpt_dir``/``--logdir`` and a resume, its checkpoints recording
  the config with its overrides, and ``OPENAI_LOG_FORMAT`` reaching the
  event writer;
- the loop refusing to run under ``torch.distributed``;
- every module of the port imports with ``jax`` and ``causaldiffae_tpu``
  blocked.
"""

import csv
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _port_fixtures import one_torch_thread  # noqa: F401  (fixture)
from causaldiffae_tpu.utils import logger as jax_logger
from causaldiffae_tpu.utils import tensorboard as jax_tb
from causaldiffae_torch.config import Config, create_diffusion, create_model
from causaldiffae_torch.training import CheckpointManager, create_train_state, run_training
from causaldiffae_torch.utils import logger
from causaldiffae_torch.utils import tensorboard as tb

REPO = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def tiny_cfg(**kw):
    """A 4-variable circuit-like model without classes, 28x28x3."""
    base = dict(name="tiny", dataset="circuit", image_size=28, in_channels=3, num_channels=32,
                num_res_blocks=1, num_heads=2, n_vars=4, rep_dim=16, attention_resolutions="7",
                rep_cond=True, causal_modeling=True, masking=True, diffusion_steps=50,
                batch_size=2, log_interval=2, save_interval=3, kl_anneal_steps=5, lr=1e-3,
                weight_decay=0.01, lr_anneal_steps=20, ema_rate="0.9,0.99",
                schedule_sampler="loss-second-moment")
    base.update(kw)
    return Config(**base)


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": (rng.randint(0, 256, (2, 28, 28, 3)) / 255).astype(np.float32),
             "c": rng.rand(2, 4).astype(np.float32)} for _ in range(n)]


def fresh_model(cfg, seed):
    torch.manual_seed(seed)
    return create_model(cfg, device="cpu")


def snapshot(state):
    """Every tensor of a train state, flattened, on the CPU."""
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"opt.{i}.{k}"] = v.clone()
    out.update({f"ema.{r}.{n}": v.clone() for r, e in state.ema.items() for n, v in e.items()})
    if state.sampler_state is not None:
        out.update({f"sampler.{k}": torch.from_numpy(np.array(v))
                    for k, v in state.sampler_state.items()})
    return out


def assert_states_equal(a, b):
    sa, sb = snapshot(a), snapshot(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step


def _drive(lg, log_fn):
    lg.logkv_mean("a", 1.0)
    lg.logkv_mean("a", 3.0)
    lg.logkv("b", 7)
    first = lg.dumpkvs()
    lg.logkv("c", 1.5)
    lg.logkv_mean("a", 2.0)
    log_fn("a message", 3)
    second = lg.dumpkvs()
    lg.logkv("b", 2)
    return first, second, lg.dumpkvs()


def test_logger_matches_jax(tmp_path, monkeypatch):
    formats = ["csv", "json", "log"]
    # the JAX logger is global: put back the one this test replaces, so that
    # no later test in the process logs through the files closed below
    monkeypatch.setattr(jax_logger, "_CURRENT", jax_logger._CURRENT)
    want = _drive(jax_logger.configure(dir=str(tmp_path / "jax"), format_strs=formats),
                  jax_logger.log)
    jax_logger.get_current().close()
    got = _drive(logger.configure(dir=str(tmp_path / "port"), format_strs=formats), logger.log)
    logger.close()
    assert got == want and want[0] == {"a": 2.0, "b": 7}
    for name in ("progress.csv", "progress.json", "log.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "progress.csv").read_text().splitlines()[0] == "a,b,c"
    # a resumed run appends to the file under the same header
    lg = logger.configure(dir=str(tmp_path / "port"), format_strs=["csv"])
    lg.logkv("a", 4.0)
    lg.logkv("d", 5)
    lg.dumpkvs()
    logger.close()
    rows = (tmp_path / "port" / "progress.csv").read_text().splitlines()
    assert rows[0] == "a,b,c,d" and rows[-1] == "4.0,,,5.0" and len(rows) == 5
    assert all(len(r.split(",")) == 4 for r in rows)
    with logger.profile_kv("data"):
        pass
    assert logger.get_current().name2val["wait_data"] >= 0.0
    logger.close()


def test_logger_without_formats_makes_no_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENAI_LOGDIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    lg = logger.configure(format_strs=[])
    assert lg.dir is None and not list(tmp_path.iterdir())
    lg.logkv("a", 1)
    assert lg.dumpkvs() == {"a": 1}
    logger.close()


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    assert tb._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    for mod in (tb, jax_tb):
        monkeypatch.setattr(mod.time, "time", lambda: 1234567890.25)
    paths = []
    for mod, name in ((tb, "port"), (jax_tb, "jax")):
        w = mod.TensorBoardWriter(str(tmp_path / name))
        w.writekvs({"loss": 0.5, "step": 3, "note": "text"})
        w.add_scalar("grad_norm", 1.25e-3, 2 ** 40)
        w.close()
        (path,) = (tmp_path / name).iterdir()
        paths.append(path)
    assert paths[0].name == paths[1].name
    assert paths[0].read_bytes() == paths[1].read_bytes() and len(paths[0].read_bytes()) > 100
    for n in (0, 1, 127, 128, 300, 2 ** 35):
        assert tb._varint(n) == jax_tb._varint(n)


def test_checkpoint_round_trip_keep3_and_latest(tmp_path):
    cfg = tiny_cfg()
    state = create_train_state(cfg, fresh_model(cfg, 0))
    run_state, _ = run_training(cfg, state.model, create_diffusion(cfg), iter(batches(4)),
                                total_steps=2, log_interval=10, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(run_state)
    mgr.save(2, run_state)
    other = create_train_state(cfg, fresh_model(cfg, 1))
    assert not torch.equal(next(other.model.parameters()), next(run_state.model.parameters()))
    mgr.restore(other)
    assert_states_equal(other, run_state)
    for step in (3, 4, 5, 6):
        mgr.save(step, run_state)
    (tmp_path / "ck" / ".step_7.pt.tmp").write_bytes(b"cut off")  # a save cut by a signal
    assert mgr.all_steps() == [4, 5, 6] and mgr.latest_step() == 6
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        ".step_7.pt.tmp", "step_4.pt", "step_5.pt", "step_6.pt"]
    bad = create_train_state(cfg.replace(ema_rate="0.5"), fresh_model(cfg, 2))
    with pytest.raises(KeyError):
        mgr.restore(bad)


def test_resume_is_bit_equal_to_a_straight_run(tmp_path, capsys):
    """6 steps straight == 3 steps, a save, a fresh loop from another init
    that resumes, and 3 more steps: every tensor of the state bit-equal."""
    cfg = tiny_cfg()
    data = batches(8)
    straight, recs = run_training(cfg, fresh_model(cfg, 0), create_diffusion(cfg), iter(data),
                                  total_steps=6, log_interval=2, device="cpu")
    assert [r["step"] for r in recs] == [2, 4, 6]
    ck = str(tmp_path / "ck")
    first, _ = run_training(cfg, fresh_model(cfg, 0), create_diffusion(cfg), iter(data),
                            total_steps=3, log_interval=2, device="cpu", ckpt_dir=ck)
    assert CheckpointManager(ck).all_steps() == [3]
    resumed, recs = run_training(cfg, fresh_model(cfg, 5), create_diffusion(cfg), iter(data[3:]),
                                 total_steps=6, log_interval=2, device="cpu", ckpt_dir=ck)
    assert [r["step"] for r in recs] == [4, 6] and recs[0]["samples"] == 8
    assert CheckpointManager(ck).all_steps() == [3, 6]
    assert straight.sampler_state["counts"].sum() == 12
    assert_states_equal(resumed, straight)
    assert "resumed from checkpoint at step 3" in capsys.readouterr().err


def test_sigterm_from_the_data_iterator_saves_and_restores_handlers(tmp_path):
    cfg = tiny_cfg(save_interval=100)
    received = []
    sentinel = lambda signum, frame: received.append(signum)  # noqa: E731

    def data():
        for i, batch in enumerate(batches(10)):
            if i == 3:  # batch 3 is fetched right after step 3 is dispatched
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    previous = signal.signal(signal.SIGTERM, sentinel)
    try:
        ck = str(tmp_path / "ck")
        state, _ = run_training(cfg, fresh_model(cfg, 0), create_diffusion(cfg), data(),
                                total_steps=8, log_interval=1, device="cpu", ckpt_dir=ck)
        assert signal.getsignal(signal.SIGTERM) is sentinel and not received
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert state.step == 3 and CheckpointManager(ck).all_steps() == [3]


def test_training_test_env_exits_after_the_first_save(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    cfg = tiny_cfg(save_interval=2)
    ck = str(tmp_path / "ck")
    state, recs = run_training(cfg, fresh_model(cfg, 0), create_diffusion(cfg), iter(batches(8)),
                               total_steps=6, log_interval=1, device="cpu", ckpt_dir=ck)
    assert state.step == 2 and [r["step"] for r in recs] == [1, 2]
    assert CheckpointManager(ck).all_steps() == [2]


def test_train_cli_checkpoints_logs_and_resumes(tmp_path, monkeypatch, capsys):
    from causaldiffae_torch import train

    cfg = tiny_cfg(schedule_sampler="uniform", ema_rate="0.9999")
    monkeypatch.setattr(train, "get_config", lambda name: cfg)
    ck, log = tmp_path / "ck", tmp_path / "log"
    args = ["--synthetic", "--device", "cpu", "--log_interval", "1", "--save_interval", "2",
            "--ckpt_dir", str(ck), "--logdir", str(log)]
    state, first = train.main(args + ["--total_steps", "2"])
    state, second = train.main(args + ["--total_steps", "3"])
    assert [r["step"] for r in first + second] == [1, 2, 3] and state.step == 3
    assert CheckpointManager(str(ck)).all_steps() == [2, 3]
    out = capsys.readouterr()
    assert [json.loads(s) for s in out.out.strip().splitlines()] == first + second
    assert "resumed from checkpoint at step 2" in out.err
    with open(log / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["step"]) for r in rows] == [1.0, 2.0, 3.0]
    assert all(np.isfinite(float(r["loss"])) and float(r["step_skipped"]) == 0.0 for r in rows)
    assert "saved checkpoint at step 3" in (log / "log.txt").read_text()
    assert CheckpointManager(str(ck)).load(3)["config"] == dataclasses.asdict(
        cfg.replace(log_interval=1, save_interval=2, total_steps=3))
    # --no_resume starts over; a preset override reaches the config and the
    # checkpoint; the env's formats reach the logdir
    monkeypatch.setenv("OPENAI_LOG_FORMAT", "csv,tensorboard")
    state, recs = train.main(args + ["--total_steps", "1", "--no_resume", "--lr", "0.5"])
    assert state.step == 1 and float(state.optimizer.param_groups[0]["lr"]) == 0.5
    assert CheckpointManager(str(ck)).load(1)["config"]["lr"] == 0.5
    (events,) = (log / "tb").iterdir()
    assert events.name.startswith("events.out.tfevents.") and events.stat().st_size > 100


def test_training_refuses_torch_distributed(tmp_path):
    import torch.distributed as dist

    cfg = tiny_cfg()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="single-process"):
            run_training(cfg, fresh_model(cfg, 0), create_diffusion(cfg), iter(batches(2)),
                         total_steps=1, log_interval=1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['causaldiffae_tpu'] = None\n"
        "import causaldiffae_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(causaldiffae_torch.__path__, "
        "'causaldiffae_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30
