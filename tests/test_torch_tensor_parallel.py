"""Tensor parallelism and ResBlock remat of the port on the CPU.

Worker processes (this file run as a script; they import no JAX) join gloo
groups through ``init_method=file://``, as ``tests/test_torch_parallel.py``
starts its ranks: 2 ranks at tp = 2 (one data row) and 4 ranks at
dp = 2 x tp = 2. They run every case once, while the test process computes
the one-process references and the JAX package's TP step.

- (a) The plan: the port shards exactly the ResBlocks and parameters that
  ``unet_param_specs`` shards, at tp = 1, 2 and 48, on the tiny config; the
  presets' full configs, built on the meta device, give the JAX rule's
  counts (the flagship: 23 blocks, 115 parameters).
- (b) Sharding is layout, never semantics: k ranks take the step one
  process takes on the same draws. Cases on the fp32 tiny config (32
  channels: 16 channels and 16 whole GroupNorm groups per shard), 2 steps,
  B = 8: the flagship (masking, the loss-second-moment sampler), dropout,
  the flow prior, and the additive embedding (no scale-shift). Params,
  gathered gradients, EMA, BatchNorm buffers, reduced metrics and the
  sampler's history held to one process at atol 2e-4, rtol 1e-3 (the
  gradient rule of ``test_torch_parallel.mismatches``); every rank's
  gathered snapshot bit-equal (the replicated tensors are the same bits on
  every TP rank, and DDP keeps the data rows alike).
- (c) The check can tell: shard-width dropout masks, the encoder's
  BatchNorm sums taken over WORLD instead of the DP group (its count is the
  DP group's rows; WORLD counts every row tp times), and a scale-shift
  chunked into tp pieces each fall outside the tolerance. (A ratio of two
  WORLD sums, as the masked KL's, would not show: both sides count every
  row tp times.)
- (d) The port's tp = 2 step against the JAX package's TP step
  (``partition_state`` over ``make_mesh(jax.devices()[:2],
  model_parallel=2)``) on the same variables, batch and draws
  (``_port_fixtures.StepPair``, with the one-process comparison's two
  microbatches, weight decay and LR anneal), at ``F32_TOL`` and its
  gradient rule; the port's model takes its shard through
  ``shard_state_dict``.
- (e) Checkpoints across tp: a tp = 2 run with remat writes step 2 (a
  tp = 1 file: its keys and shapes equal a one-process run's) and resumes
  at tp = 2 and at tp = 1 to step 3, both equal to 3 straight steps; the
  serve CLI answers from it. The resumed tp = 2 step counts its TP
  all-reduces: one forward per sharded block, two in the backward, two for
  the norms, and none in remat's recompute (see the test).
- (f) Remat: one step with ``use_remat`` and dropout is bit-equal to the
  step without it, and checkpoints every ResBlock.
- (g) The CLI: ``--model_parallel`` and ``--use_remat`` parse, and a world
  size that tp does not divide is refused.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _port_fixtures import F32_TOL, PARAM_ATOL, STEP0, STEP_B, STEP_LR, make_batch, tiny_kwargs
from test_torch_parallel import B, STEPS, build, config, global_batches, local, mismatches

REPO = Path(__file__).resolve().parent.parent
TP = 2
GROUPS = {"tp2": (2, 2), "dp2tp2": (4, 2)}  # name -> (world, tp)
CASES = {  # name -> config overrides
    "flagship": dict(schedule_sampler="loss-second-moment"),
    "dropout": dict(dropout=0.1),
    "flow": dict(flow_based=True, masking=False),
    "additive": dict(use_scale_shift_norm=False),
}
MUTATIONS = {  # name -> the case it breaks
    "shard_dropout": "dropout",
    "world_bn": "flagship",
    "chunk_emb": "flagship",
}
RESUME_METRICS = ("loss", "mse", "kld_rep", "grad_norm", "param_norm")
# (d) runs the config of the one-process comparison (test_torch_train_step.py):
# two microbatches, weight decay, an LR anneal
JAX_OVERRIDES = dict(microbatch=STEP_B // 2, weight_decay=0.05, lr_anneal_steps=4)


def _cfg(name, **kw):
    return config(**{**CASES.get(name, {}), **kw})


def snapshot(state, metrics):
    """Every tensor the comparison reads, the shards gathered to the whole
    model, as numpy under a kind prefix (``test_torch_parallel.snapshot``)."""
    from causaldiffae_torch.parallel.partition import gather_state_dict

    plan = getattr(state.model, "shard_plan", None)
    full = (lambda d: gather_state_dict(d, plan)) if plan is not None else dict
    named = dict(state.model.named_parameters())
    out = {}
    for kind, tensors in (("param", {n: p.detach() for n, p in named.items()}),
                          ("grad", {n: p.grad for n, p in named.items()}),
                          ("ema", next(iter(state.ema.values())))):
        for n, v in full(tensors).items():
            out[f"{kind}/{n}"] = v.numpy().copy()
    for n, b in state.model.named_buffers():
        if "running" in n:
            out[f"buffer/{n}"] = b.numpy().copy()
    for k in metrics[0]:
        out[f"metric/{k}"] = np.asarray([m[k] for m in metrics], np.float64)
    if state.sampler_state is not None:
        for k, v in state.sampler_state.items():
            out[f"sampler/{k}"] = np.asarray(v)
    return out


def run_case(name, tp=1):
    """2 steps of case ``name`` on this rank's rows at ``tp`` model ranks
    (one process: tp = 1, all the rows)."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.parallel import dp_group, init_grid, reduce_metrics
    from causaldiffae_torch.parallel.partition import shard_model_, unet_shard_plan
    from causaldiffae_torch.training import create_train_state, make_train_step
    from causaldiffae_torch.training.loop import wrap_model

    cfg = _cfg(MUTATIONS.get(name, name))
    grid = init_grid(tp)
    model = build(cfg)
    if tp > 1:
        shard_model_(model, unet_shard_plan(model, tp))
    state = create_train_state(cfg, model)
    state.step = 1  # the KL weight is 1 from here on (kl_anneal_steps=2)
    step = make_train_step(cfg, wrap_model(cfg, model, "cpu"), create_diffusion(cfg),
                           state.optimizer)
    metrics = []
    for batch in local(global_batches(STEPS), cfg, grid.dp_rank, grid.dp):
        m = reduce_metrics(step(state, {k: torch.from_numpy(v) for k, v in batch.items()}),
                           dp_group())
        metrics.append({k: float(v) for k, v in m.items()})
    return snapshot(state, metrics)


def resume_config(tp):
    return config(model_parallel=tp, use_remat=tp > 1)


def run_resume(ckpt_dir, tp=1, mode="write_and_resume"):
    """``mode`` "straight": 3 steps, with checkpoints at 2 and 3 under
    ``ckpt_dir``; "write_and_resume": steps 1-2 and a checkpoint, then a
    fresh loop from another init that resumes and takes step 3; "resume":
    that second loop alone. Returns the snapshot and the TP all-reduces of
    the last loop."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.parallel import init_grid
    from causaldiffae_torch.parallel.collectives import TP_ALL_REDUCES
    from causaldiffae_torch.training import run_training

    cfg = resume_config(tp)
    grid = init_grid(tp)
    data = local(global_batches(4), cfg, grid.dp_rank, grid.dp)
    kw = dict(log_interval=1, device="cpu", ckpt_dir=ckpt_dir)
    if mode == "straight":
        state, recs = run_training(cfg, build(cfg), create_diffusion(cfg), iter(data),
                                   total_steps=3, **kw)
    else:
        if mode == "write_and_resume":
            run_training(cfg, build(cfg), create_diffusion(cfg), iter(data[:3]), total_steps=2,
                         **kw)
        TP_ALL_REDUCES.update(dict.fromkeys(TP_ALL_REDUCES, 0))
        state, recs = run_training(cfg, build(cfg, seed=7), create_diffusion(cfg),
                                   iter(data[2:]), total_steps=3, **kw)
    assert state.step == 3 and recs[-1]["step"] == 3
    return snapshot(state, [{k: recs[-1][k] for k in RESUME_METRICS}]), dict(TP_ALL_REDUCES)


def run_jax_case(out):
    """The JAX comparison's port side: the tp = 2 step at STEP0 on the
    variables, batch and draws the test process wrote."""
    from causaldiffae_torch.config import Config, create_diffusion, create_model
    from causaldiffae_torch.parallel import init_grid
    from causaldiffae_torch.parallel.partition import (shard_model_, shard_state_dict,
                                                       unet_shard_plan)
    from causaldiffae_torch.training import create_train_state, make_train_step

    cfg = Config(use_kernels=True, **tiny_kwargs(use_bf16=False, batch_size=STEP_B, lr=STEP_LR,
                                                 kl_anneal_steps=10, **JAX_OVERRIDES))
    init_grid(TP)
    with np.load(out / "jax_in.npz") as z:
        arrays = {k: torch.from_numpy(z[k]) for k in z.files}
    model = create_model(cfg, device="cpu")
    plan = unet_shard_plan(model, TP)
    shard_model_(model, plan)
    model.load_state_dict(shard_state_dict({k[3:]: v for k, v in arrays.items()
                                            if k.startswith("sd/")}, plan), strict=True)
    state = create_train_state(cfg, model)
    state.step = STEP0
    step = make_train_step(cfg, model, create_diffusion(cfg), state.optimizer)
    batch = {k[6:]: v for k, v in arrays.items() if k.startswith("batch/")}
    draws = {k[6:]: v for k, v in arrays.items() if k.startswith("draws/")}
    m = step(state, batch, draws=draws)
    return snapshot(state, [{k: float(v) for k, v in m.items()}])


def _patch(name):
    """Break the TP path the way mutation ``name`` says; returns the undo."""
    from causaldiffae_torch.models import encoder
    from causaldiffae_torch.models.layers import ResBlock

    if name == "shard_dropout":  # the mask drawn at the shard's width
        saved = ResBlock.keep_mask

        def keep_mask(self, x, drop):
            if not (self.training and self.out_layers[2].p > 0):
                return None
            width = self.out_channels // (self.tp.size if self.tp else 1)
            return drop(torch.Size((x.shape[0], width, *x.shape[2:]))).bool()

        ResBlock.keep_mask = keep_mask
        return lambda: setattr(ResBlock, "keep_mask", saved)
    if name == "world_bn":  # BatchNorm's sums over every rank, its count the DP group's
        saved = encoder.dp_group
        encoder.dp_group = lambda: None
        return lambda: setattr(encoder, "dp_group", saved)
    if name == "chunk_emb":  # [scale | shift] chunked into tp pieces
        saved = ResBlock.scale_shift

        def scale_shift(self, emb_out):
            if self.tp is None:
                return saved(self, emb_out)
            return torch.chunk(torch.chunk(emb_out, self.tp.size, dim=-1)[self.tp.rank], 2, -1)

        ResBlock.scale_shift = scale_shift
        return lambda: setattr(ResBlock, "scale_shift", saved)
    raise KeyError(name)


def _worker(group, rank, world, store, out):
    import torch.distributed as dist

    rank, world, out = int(rank), int(world), Path(out)
    tp = GROUPS[group][1]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    for name in CASES:
        np.savez(out / f"{group}_{name}_{rank}.npz", **run_case(name, tp))
    if group == "tp2":
        for name in MUTATIONS:
            undo = _patch(name)
            try:
                np.savez(out / f"{group}_{name}_{rank}.npz", **run_case(name, tp))
            finally:
                undo()
        np.savez(out / f"{group}_jax_{rank}.npz", **run_jax_case(out))
        snap, reduces = run_resume(str(out / "ckpt_tp2"), tp)
        np.savez(out / f"{group}_resume_{rank}.npz", **snap)
        (out / f"reduces_{rank}.json").write_text(json.dumps(reduces))
    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "causaldiffae_tpu" not in sys.modules
    print(f"rank {rank}: OK", flush=True)


def _jax_inputs(out):
    """The JAX side of (d): its variables (as the port's full state dict),
    batch and draws go to ``out/jax_in.npz`` for the workers; returns the
    pair and the batch for the JAX TP step."""
    from causaldiffae_torch.utils.weights import state_dict_from_flax

    from _port_fixtures import StepPair

    pair = StepPair(False, **JAX_OVERRIDES)
    batch = make_batch(0)
    arrays = {f"sd/{k}": v.numpy() for k, v in
              state_dict_from_flax(pair.pcfg, pair.variables).items()}
    arrays.update({f"draws/{k}": v.numpy() for k, v in pair.draws().items()})
    arrays.update({f"batch/{k}": v.astype(np.int64) if k == "y" else v
                   for k, v in batch.items()})
    np.savez(out / "jax_in.npz", **arrays)
    return pair, batch


def _jax_tp_step(pair, batch):
    """The JAX package's step on the (1 data x 2 model) mesh; returns the
    metrics, params and gradients under the port's keys."""
    import jax

    from causaldiffae_tpu.parallel import make_mesh, partition_state, shard_batch

    mesh = make_mesh(jax.devices()[:TP], model_parallel=TP)
    state = partition_state(pair.jstate, mesh)
    state, jm = pair.jstep(state, shard_batch(mesh, pair._jax_batch(batch)))
    pair.jstate = state
    return ({k: float(v) for k, v in jm.items()}, pair.port_sd(state.params),
            pair.jax_grads())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts both groups of ranks, computes the references and the JAX TP
    step meanwhile, and returns (output directory, references)."""
    out = tmp_path_factory.mktemp("tensor_parallel")
    pair, batch = _jax_inputs(out)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for group, (world, _) in GROUPS.items():
        for r in range(world):
            logs.append(open(out / f"{group}_{r}.log", "w"))
            procs.append((group, r, subprocess.Popen(
                [sys.executable, __file__, group, str(r), str(world), str(out / f"store_{group}"),
                 str(out)], cwd=REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT)))
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            refs = {name: run_case(name) for name in CASES}
            refs["resume"], _ = run_resume(str(out / "ckpt_tp1"), mode="straight")
            refs["jax"] = _jax_tp_step(pair, batch)
        finally:
            torch.set_num_threads(n)
        for _, _, p in procs:
            p.wait(timeout=600)
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for group, r, p in procs:
        text = (out / f"{group}_{r}.log").read_text()
        assert p.returncode == 0 and f"rank {r}: OK" in text, f"{group} rank {r}:\n{text[-4000:]}"
    return out, refs


def load_ranks(out, group, name, same=True):
    """Rank 0's snapshot; with ``same``, every rank's must be bit-equal to it."""
    ranks = [dict(np.load(out / f"{group}_{name}_{r}.npz"))
             for r in range(GROUPS[group][0])]
    for other in ranks[1:]:
        for k, v in ranks[0].items():
            assert not same or v.tobytes() == other[k].tobytes(), (group, name, k)
    return ranks[0]


def _plans(tp):
    """(the port's sharded parameters -> dims, the JAX rule's sharded port
    keys) on the tiny config at ``tp``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from causaldiffae_tpu.parallel import unet_param_specs
    from causaldiffae_torch.config import Config, create_model
    from causaldiffae_torch.parallel.partition import unet_shard_plan
    from causaldiffae_torch.utils.weights import state_dict_from_flax

    from _port_fixtures import configs, flax_variables

    jcfg, _ = configs(False)
    _, variables = flax_variables(jcfg)
    specs = unet_param_specs(variables["params"], tp)
    # carry a 1 through every leaf the JAX rule shards, 0 elsewhere, to the port's keys
    ones = jax.tree_util.tree_map(
        lambda spec, a: np.full(a.shape, float(any(ax is not None for ax in spec)), np.float32),
        specs, variables["params"], is_leaf=lambda x: isinstance(x, P))
    cfg = Config(**tiny_kwargs())
    sd = state_dict_from_flax(cfg, {"params": ones, "batch_stats": variables["batch_stats"]})
    jax_keys = {k for k, v in sd.items() if "running" not in k and "num_batches" not in k
                and bool((v == 1).all())}
    plan = unet_shard_plan(create_model(cfg, device="cpu"), tp)
    return plan, jax_keys, specs


@pytest.mark.parametrize("tp", [1, 2, 48])
def test_plan_shards_what_the_jax_rule_shards(tp):
    from causaldiffae_torch.parallel.partition import RESBLOCK_LEAVES, count_sharded

    plan, jax_keys, specs = _plans(tp)
    assert set(plan.leaves) == jax_keys
    assert count_sharded(plan) == len(jax_keys) == 5 * len(plan.blocks)
    assert (len(plan.blocks) > 0) == (tp == 2)
    for key, dim in plan.leaves.items():
        assert dim == RESBLOCK_LEAVES[".".join(key.split(".")[-3:])]
    if tp == 2:  # the conv pair's dims: flax [3, 3, Cin, Cout] -> torch [Cout, Cin, 3, 3]
        rb = specs["input_blocks_1_0"]
        assert rb["Conv3x3_0"]["Conv_0"]["kernel"][3] is not None
        assert rb["Conv3x3_1"]["Conv_0"]["kernel"][2] is not None
        assert plan.leaves["input_blocks.1.0.in_layers.2.weight"] == 0
        assert plan.leaves["input_blocks.1.0.out_layers.3.weight"] == 1


@pytest.mark.parametrize("preset,blocks,share", [("morphomnist_causaldae", 23, 0.706),
                                                 ("circuit_causaldae", 44, 0.741),
                                                 ("pendulum_causaldae", 30, 0.795)])
def test_full_config_plans_on_the_meta_device(preset, blocks, share):
    """The presets' full widths, built on the meta device: the counts of the
    JAX rule at tp = 2 and 4, and the share of the parameters in sharded leaves."""
    from causaldiffae_torch.config import create_model, get_config
    from causaldiffae_torch.parallel.partition import count_sharded, unet_shard_plan

    with torch.device("meta"):
        model = create_model(get_config(preset), device="meta")
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    for tp in (2, 4):
        plan = unet_shard_plan(model, tp)
        assert (len(plan.blocks), count_sharded(plan)) == (blocks, 5 * blocks)
        got = sum(sizes[k] for k in plan.leaves) / sum(sizes.values())
        assert abs(got - share) < 5e-4, got


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", CASES)
def test_tp_ranks_take_the_one_process_step(runs, group, name):
    out, refs = runs
    got, want = load_ranks(out, group, name), refs[name]
    assert set(got) == set(want)
    assert mismatches(got, want) == []
    if name == "flagship":  # every data row's (t, loss) pairs pushed once, in global order
        assert got["sampler/counts"].sum() == STEPS * B


@pytest.mark.parametrize("name", MUTATIONS)
def test_broken_tp_paths_fall_outside_the_tolerance(runs, name):
    out, refs = runs
    bad = mismatches(load_ranks(out, "tp2", name, same=False), refs[MUTATIONS[name]])
    assert any(k.startswith("grad/") for k in bad), bad


def test_tp_step_matches_the_jax_tp_step(runs):
    out, refs = runs
    jm, params, grads = refs["jax"]
    got = load_ranks(out, "tp2", "jax")
    for k in ("loss", "mse", "kld_rep", "grad_norm", "param_norm", "kl_weight"):
        np.testing.assert_allclose(got[f"metric/{k}"][0], jm[k], err_msg=k, **F32_TOL)
    rms = float(np.sqrt(np.mean(np.concatenate([w.ravel() for w in grads.values()]) ** 2)))
    for name, w in grads.items():
        if f"grad/{name}" not in got:
            continue  # BatchNorm buffers
        np.testing.assert_allclose(got[f"grad/{name}"], w, rtol=1e-3,
                                   atol=max(2e-4 * float(np.abs(w).max()), 1e-3 * rms),
                                   err_msg=name)
        np.testing.assert_allclose(got[f"param/{name}"], params[name], atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def _shapes(saved):
    """Every tensor's shape in a saved state, by its place."""
    from causaldiffae_torch.utils.determinism import tensors

    return {path: tuple(v.shape) for path, v in tensors(saved)}


def test_checkpoint_across_tp(runs, tmp_path):
    """A tp = 2 checkpoint is a tp = 1 file; it resumes at tp = 2 (the
    ranks) and at tp = 1 (here) to 3 straight steps' state, and serves."""
    from causaldiffae_torch import serve
    from causaldiffae_torch.training import CheckpointManager

    out, refs = runs
    want = refs["resume"]
    assert mismatches(load_ranks(out, "tp2", "resume"), want) == []
    saved = CheckpointManager(str(out / "ckpt_tp2")).load(2)
    plain = CheckpointManager(str(out / "ckpt_tp1")).load(2)
    assert _shapes(saved) == _shapes(plain)
    for k, v in plain["model"].items():
        np.testing.assert_allclose(saved["model"][k].numpy(), v.numpy(), atol=2 * PARAM_ATOL,
                                   rtol=F32_TOL["rtol"], err_msg=k)
    assert saved["config"]["model_parallel"] == 2

    ckpt = tmp_path / "ckpt"
    shutil.copytree(out / "ckpt_tp2", ckpt)
    os.remove(ckpt / "step_3.pt")
    got, _ = run_resume(str(ckpt), mode="resume")  # one process: tp = 1
    assert mismatches(got, want) == []
    recs = serve.main(["--ckpt_dir", str(out / "ckpt_tp2"), "--synthetic", "2", "--batch", "2",
                       "--value", "1.0", "--sampler", "dpm++", "--sample_steps", "3",
                       "--device", "cpu"])
    assert len(recs) == 1 and recs[0]["finite"]


def test_tp_all_reduces_per_step(runs):
    """The resumed tp = 2 step with remat: per sharded block one all-reduce
    forward and two backward (f on h and on the embedding projection), and
    two for the grad and param norms. Remat's recompute repeats none: torch's
    non-reentrant checkpoint stops recomputing at the block's last saved
    tensor (its default early stop), the row conv's input, before g; the
    skip conv, which saves x, runs before the sharded region."""
    from causaldiffae_torch.config import create_model
    from causaldiffae_torch.parallel.partition import unet_shard_plan

    out, _ = runs
    n = len(unet_shard_plan(create_model(resume_config(TP), device="cpu"), TP).blocks)
    for r in range(GROUPS["tp2"][0]):
        got = json.loads((out / f"reduces_{r}.json").read_text())
        assert got == {"forward": n, "recompute": 0, "backward": 2 * n, "step": 2}


def test_remat_changes_no_value_with_dropout(monkeypatch):
    """One step with ``use_remat`` and dropout bit-equal to the step without;
    every ResBlock ran under ``torch.utils.checkpoint``."""
    import causaldiffae_torch.models.unet as unet
    from causaldiffae_torch.config import create_model
    from causaldiffae_torch.models.layers import ResBlock

    calls = []
    checkpoint = unet.checkpoint
    monkeypatch.setattr(unet, "checkpoint", lambda fn, *a, **k: (calls.append(fn.__self__),
                                                                 checkpoint(fn, *a, **k))[1])
    runs = {}
    for remat in (False, True):
        cfg = config(dropout=0.1, use_remat=remat)
        assert create_model(cfg, device="cpu").use_remat is remat
        runs[remat] = run_case_cfg(cfg)
    blocks = [m for m in build(config()).modules() if isinstance(m, ResBlock)]
    assert len(calls) == len(blocks) * STEPS
    for k, v in runs[False].items():
        assert v.tobytes() == runs[True][k].tobytes(), k


def run_case_cfg(cfg):
    """2 one-process steps of ``cfg`` (``run_case`` with a config of its own)."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.training import create_train_state, make_train_step

    state = create_train_state(cfg, build(cfg))
    state.step = 1
    step = make_train_step(cfg, state.model, create_diffusion(cfg), state.optimizer)
    metrics = [{k: float(v) for k, v in step(state, {k: torch.from_numpy(v) for k, v in
                                                     b.items()}).items()}
               for b in global_batches(STEPS)]
    return snapshot(state, metrics)


def test_cli_flags_and_an_indivisible_world():
    from causaldiffae_torch import train

    args = train.parse_args(["--model_parallel", "2", "--use_remat", "true"])
    assert (args.model_parallel, args.use_remat) == (2, True)
    assert train.parse_args([]).model_parallel is None
    with pytest.raises(SystemExit):
        train.parse_args(["--model_parallel", "0"])
    # one process, no process group: world size 1, which 2 does not divide
    with pytest.raises(SystemExit, match="does not divide the world size 1"):
        train.main(["--model_parallel", "2", "--device", "cpu", "--total_steps", "1"])


if __name__ == "__main__":
    _worker(*sys.argv[1:])
