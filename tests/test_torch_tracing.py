"""The port's tracing (``utils/tracing.py``) and the benchmark readers of it.

- spans: nesting and self time, the first occurrence kept apart, nothing
  added while ``torch.profiler`` runs, where the spans are ranges in the
  profiler's events instead, nested as they ran; the counters, those kept
  by the attention kernels' module among them; the profiling tools' span
  table and device operations;
- a tiny ``run_training`` (its feed, step, readback and set-up spans, and its
  records' ``wait_data``), tiny DPM++ and DDIM-inversion counterfactuals (one
  UNet call per chain step, counted and timed), and the traceable chain's
  exported graph, which holds no profiler op;
- each per-layer reader of the program's spans (``benchmark/metrics``) on a
  hand-built ``benchmark.trace.Trace`` and snapshot, and on a program without
  the tracing module, where it reads nothing.
"""

import importlib.util
import itertools
import sys
from pathlib import Path

import pytest
import torch

from _port_fixtures import one_torch_thread, tiny_kwargs  # noqa: F401
from benchmark.trace import Event, Trace
from causaldiffae_torch.utils import tracing

METRICS = Path(__file__).resolve().parent.parent / "benchmark" / "metrics"


@pytest.fixture
def fake_clock(monkeypatch):
    """The spans' clock ticks 10 ns at each reading."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    tracing.reset()
    yield
    tracing.reset()


def test_nesting_self_time_and_first_occurrence(fake_clock):
    for _ in range(2):
        with tracing.span("cdae.t.outer"):          # reads the clock at 0, then at 50
            with tracing.span("cdae.t.inner"):      # 10 and 20
                pass
            with tracing.span("cdae.t.inner"):      # 30 and 40
                pass
    spans = tracing.snapshot()["spans"]
    outer, inner = spans["cdae.t.outer"], spans["cdae.t.inner"]
    assert outer["n"] == 2 and inner["n"] == 4
    assert outer["s"] == pytest.approx(100e-9) and outer["first_s"] == pytest.approx(50e-9)
    assert outer["self_s"] == pytest.approx(60e-9)   # 50 less its children's 20, twice
    assert inner["s"] == inner["self_s"] == pytest.approx(40e-9)
    assert inner["first_s"] == pytest.approx(10e-9)


def test_a_span_that_raises_is_closed(fake_clock):
    with pytest.raises(ValueError):
        with tracing.span("cdae.t.outer"):
            with tracing.span("cdae.t.inner"):
                raise ValueError
    with tracing.span("cdae.t.after"):
        pass
    spans = tracing.snapshot()["spans"]
    assert spans["cdae.t.inner"]["n"] == spans["cdae.t.outer"]["n"] == 1
    assert spans["cdae.t.after"]["self_s"] == spans["cdae.t.after"]["s"]
    assert not tracing._open


def test_counters_and_the_attention_launches_reset(fake_clock, monkeypatch):
    """``reset`` clears the counters of ``count``; the attention and norm
    launch counters are read where their modules keep them, and left alone."""
    from causaldiffae_torch.ops import attention, norm_act

    monkeypatch.setattr(attention.attention_fwd, "launches", 3)
    monkeypatch.setattr(attention.attention_fwd, "lse_launches", 1)
    monkeypatch.setattr(attention.attention_bwd, "launches", 2)
    monkeypatch.setattr(norm_act.norm_act_fwd, "launches", 62)
    monkeypatch.setattr(norm_act.norm_act_bwd, "launches", 31)
    tracing.count("cdae.t.calls")
    tracing.count("cdae.t.calls", 2)
    counters = tracing.snapshot()["counters"]
    assert counters["cdae.t.calls"] == 3
    launches = {"cdae.attention_fwd.launches": 3, "cdae.attention_fwd.lse_launches": 1,
                "cdae.attention_bwd.launches": 2, "cdae.norm_act_fwd.launches": 62,
                "cdae.norm_act_bwd.launches": 31}
    assert {k: counters[k] for k in launches} == launches
    attention.attention_fwd.launches += 1
    norm_act.norm_act_bwd.launches += 31
    assert tracing.snapshot()["counters"]["cdae.attention_fwd.launches"] == 4
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {
        **launches, "cdae.attention_fwd.launches": 4, "cdae.norm_act_bwd.launches": 62}}
    assert attention.attention_fwd.launches == 4
    assert norm_act.norm_act_bwd.launches == 62


def test_span_table_is_self_ms_per_unit_largest_first():
    snap = {"spans": {"cdae.a": {"n": 2, "s": 0.5, "self_s": 0.1, "first_s": 0.3},
                      "cdae.b": {"n": 4, "s": 0.4, "self_s": 0.4, "first_s": 0.1}},
            "counters": {}}
    table = tracing.span_table(snap, 4)
    assert list(table) == ["cdae.b", "cdae.a"]
    assert table == pytest.approx({"cdae.b": 100.0, "cdae.a": 25.0})


def test_device_ops_leave_out_host_ops_and_spans():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("cdae.t.outer"):
            torch.ones(4).sum()
    assert tracing.device_ops(prof) == []   # no device here: nothing but host events


def test_under_the_profiler_spans_are_ranges_and_add_nothing(fake_clock):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("cdae.t.outer"):
            with tracing.span("cdae.t.inner"):
                torch.ones(4).sum()
            tracing.count("cdae.t.calls")
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"]["cdae.t.calls"] == 1
    events = {e.name: e for e in prof.events() if e.name.startswith("cdae.")}
    outer, inner = events["cdae.t.outer"].time_range, events["cdae.t.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    ops = [e.time_range for e in prof.events() if e.name == "aten::sum"]
    assert ops and inner.start <= ops[0].start and ops[0].end <= inner.end
    with tracing.span("cdae.t.outer"):   # afterwards, timed again
        pass
    assert tracing.snapshot()["spans"]["cdae.t.outer"]["n"] == 1


def test_a_span_that_ends_under_a_profiler_adds_nothing(fake_clock):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    with tracing.span("cdae.t.outer"):
        prof.__enter__()
    prof.__exit__(None, None, None)
    assert tracing.snapshot()["spans"] == {} and not tracing._open


# -- the port on the CPU ------------------------------------------------------ #

def _port_cfg(**overrides):
    from causaldiffae_torch.config import Config

    return Config(**tiny_kwargs(**overrides))


@pytest.fixture(scope="module")
def trained(one_torch_thread):  # noqa: F811
    """Two logged steps of ``run_training`` on the CPU, traced from a reset."""
    from causaldiffae_torch.config import create_diffusion, create_model
    from causaldiffae_torch.data import synthetic_dataset
    from causaldiffae_torch.training import run_training
    from causaldiffae_torch.utils import logger

    cfg = _port_cfg(batch_size=4, seed=0)
    data = synthetic_dataset(cfg.dataset, 12, seed=0, image_size=cfg.image_size)
    batches = iter([{k: v[i:i + 4] for k, v in data.items()} for i in range(0, 12, 4)])
    tracing.reset()
    logger.configure(format_strs=[])
    model = create_model(cfg, device="cpu")
    _, records = run_training(cfg, model, create_diffusion(cfg), batches, total_steps=2,
                              log_interval=1, device="cpu")
    snap = tracing.snapshot()
    tracing.reset()
    return snap, records


def test_training_spans(trained):
    spans, _ = trained[0]["spans"], trained[1]
    for name in ("cdae.setup.create_model", "cdae.setup.train_state", "cdae.setup.train_step"):
        assert spans[name]["n"] == 1
    step = spans["cdae.train.step"]
    assert step["n"] == 2
    children = [spans[f"cdae.train.step.{k}"] for k in
                ("forward", "backward", "optimizer", "ema", "metrics")]
    assert all(c["n"] == 2 for c in children)
    assert step["self_s"] == pytest.approx(step["s"] - sum(c["s"] for c in children), abs=1e-9)
    metrics, wait = spans["cdae.train.step.metrics"], spans["cdae.train.step.wait"]
    assert wait["n"] == 2 and wait["s"] < metrics["s"]   # the kl_weight copy alone
    assert metrics["self_s"] == pytest.approx(metrics["s"] - wait["s"], abs=1e-9)
    forward = spans["cdae.train.step.forward"]
    denoise = spans["cdae.unet.denoise"]
    assert denoise["n"] == 2 and denoise["s"] <= forward["s"] - forward["self_s"] + 1e-9
    # the feed fetched each step's batch and the next (three), made two ready
    assert spans["cdae.train.data.next"]["n"] == spans["cdae.train.data.copy"]["n"] == 3
    assert spans["cdae.train.data.ready"]["n"] == 2
    assert spans["cdae.train.readback"]["n"] == 2
    assert all(k.startswith("cdae.") for k in [*spans, *trained[0]["counters"]])
    assert trained[0]["counters"]["cdae.unet.calls"] == 2


def test_readback_wait_is_timed(fake_clock):
    """The loop's wait for its metrics' copy runs in ``cdae.train.readback.wait``
    (a card's event; none on the CPU, where there is nothing to wait for)."""
    from causaldiffae_torch.training.loop import _wait_readback

    waited = []

    class Event:
        def synchronize(self):
            waited.append(1)

    _wait_readback(None)
    assert tracing.snapshot()["spans"] == {}
    _wait_readback(Event())
    assert waited == [1] and tracing.snapshot()["spans"]["cdae.train.readback.wait"]["n"] == 1


def test_loop_records_carry_wait_data(trained):
    snap, records = trained
    assert [r["step"] for r in records] == [1, 2]
    feed = sum(snap["spans"][k]["s"] for k in
               ("cdae.train.data.next", "cdae.train.data.copy", "cdae.train.data.ready"))
    # each record's feed seconds since the one before it: all of them by the
    # first record's dump, which the lagged readback makes at step 2
    waits = [r["wait_data"] for r in records]
    assert waits[0] > 0 and sum(waits) == pytest.approx(feed)


@pytest.mark.parametrize("sampler,steps,abduction,chains", [
    ("dpm++", 3, "qsample", 1),
    ("ddim", None, "ddim", 2),   # the inversion is a chain too
])
def test_chain_counts_one_unet_call_per_step(one_torch_thread, sampler, steps,  # noqa: F811
                                             abduction, chains):
    from causaldiffae_torch.config import create_diffusion, create_model
    from causaldiffae_torch.evals.counterfactual import make_counterfactual_fn

    cfg = _port_cfg(eval_timestep_respacing="4", abduction_t=3)
    model = create_model(cfg, device="cpu")
    diffusion = create_diffusion(cfg, eval_mode=True)
    calls = []
    denoise = model.denoise
    model.denoise = lambda *a, **kw: calls.append(1) or denoise(*a, **kw)
    tracing.reset()
    fn = make_counterfactual_fn(cfg, model, diffusion, intervene_var=0, sampler=sampler,
                                sample_steps=steps, abduction=abduction)
    x = torch.zeros(2, 28, 28, 1)
    fn(x, {"y": torch.zeros(2, dtype=torch.long)}, 0.5, torch.Generator().manual_seed(0))
    snap = tracing.snapshot()
    tracing.reset()
    spans, counters = snap["spans"], snap["counters"]
    assert calls and counters["cdae.unet.calls"] == len(calls)
    assert spans["cdae.chain.step"]["n"] == spans["cdae.unet.denoise"]["n"] == len(calls)
    for name in ("cdae.setup.chain", "cdae.cf.request", "cdae.cf.prepare"):
        assert spans[name]["n"] == 1
    assert spans["cdae.cf.chain"]["n"] == chains
    request, chain = spans["cdae.cf.request"], spans["cdae.cf.chain"]
    assert request["self_s"] == pytest.approx(
        request["s"] - chain["s"] - spans["cdae.cf.prepare"]["s"], abs=1e-9)
    assert chain["self_s"] == pytest.approx(chain["s"] - spans["cdae.chain.step"]["s"], abs=1e-9)


def test_traceable_chain_exports_no_profiler_op(one_torch_thread):  # noqa: F811
    """The chain's ``while_loop`` form, exported with a span and a counter
    in each step and around the chain, holds no profiler op and counts
    nothing; run eagerly, the same step is timed."""
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.diffusion.sampling import dpm_solver_pp_loop

    diffusion = create_diffusion(_port_cfg(), eval_mode=True)

    def model_fn(x, t):
        tracing.count("cdae.unet.calls")
        with tracing.span("cdae.unet.denoise"):
            return 0.5 * x

    class Chain(torch.nn.Module):
        def forward(self, x):
            with tracing.span("cdae.cf.chain"):
                return dpm_solver_pp_loop(diffusion, model_fn, x, num_steps=4, traceable=True,
                                          clip_denoised=False)

    x = torch.ones(2, 4, 4, 1)
    diffusion.arrays_on(x.device)
    tracing.reset()
    ep = torch.export.export(Chain(), (x,))
    assert tracing.snapshot()["spans"] == {}
    assert "cdae.unet.calls" not in tracing.snapshot()["counters"]
    targets = [str(n.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes]
    assert "while_loop" in " ".join(targets)
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    out = ep.module()(x)
    eager = dpm_solver_pp_loop(diffusion, model_fn, x, num_steps=4, clip_denoised=False)
    torch.testing.assert_close(out, eager)
    assert tracing.snapshot()["spans"]["cdae.chain.step"]["n"] >= 2


# -- the benchmark's readers of the program's spans --------------------------- #

def _reader(name):
    spec = importlib.util.spec_from_file_location(f"_t_metric_{name.replace('.', '_')}",
                                                  METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _agg(n, s, first_s, self_s=None):
    return {"n": n, "s": s, "first_s": first_s, "self_s": s if self_s is None else self_s}


SNAPSHOT = {"spans": {
    "cdae.train.data.next": _agg(11, 0.110, 0.010),      # 10 warm at 10 ms
    "cdae.train.data.copy": _agg(11, 0.060, 0.020),      # 4 ms
    "cdae.train.data.ready": _agg(11, 0.021, 0.001),     # 2 ms
    "cdae.train.step": _agg(11, 3.0, 1.0, 0.5),          # 200 ms
    "cdae.train.step.wait": _agg(11, 1.6, 0.1),          # 150 ms
    "cdae.unet.denoise": _agg(5, 0.5, 0.1),              # 100 ms
    "cdae.cf.prepare": _agg(3, 0.03, 0.01),              # 10 ms
    "cdae.setup.prepare_forward": _agg(1, 5.0, 5.0, 2.0),
    "cdae.setup.build": _agg(2, 3.0, 2.9),
    "cdae.setup.create_model": _agg(1, 0.5, 0.5),
}, "counters": {}}

# a hand-built profiled window of two steps (us): the device ran [10, 30],
# [50, 60] and [90, 95]; the host was in the steps [0, 40] and [40, 100],
# each waiting from 30 and from 80
TRACE = Trace(
    device=[Event("k", 10, 30), Event("k", 50, 60), Event("k", 90, 95)],
    host=[Event("bench.profiled", 0, 100),
          Event("cdae.train.step", 0, 40), Event("cdae.train.step.wait", 30, 40),
          Event("cdae.train.step", 40, 100), Event("cdae.train.step.wait", 80, 100),
          Event("cdae.cf.chain", 45, 85)],
    counts={"steps": 2, "requests": 2}, config={}, traffic={})


@pytest.mark.parametrize("name,want", [
    ("feed_host_ms.train", 16.0),
    ("loader_next_ms.train", 10.0),
    ("step_dispatch_ms.train", 50.0),
    ("step_wait_ms.train", 150.0),
    ("unet_host_ms.serve", 100.0),
    ("prepare_host_ms.serve", 10.0),
    ("setup_program_s", 5.5),
    # gaps [0, 10], [30, 50], [60, 90], [95, 100]: begun in a step, not waiting:
    # 0 and 60, 10 + 30 us over 2 steps
    ("idle_in_step_ms.train", 0.02),
    # begun outside the chain [45, 85]: 0, 30 and 95, 10 + 20 + 5 us over 2 requests
    ("idle_outside_chain_ms.serve", 0.0175),
])
def test_reader_on_a_hand_built_trace_and_snapshot(monkeypatch, name, want):
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)
    assert _reader(name)(TRACE) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "feed_host_ms.train", "loader_next_ms.train", "step_dispatch_ms.train",
    "step_wait_ms.train", "unet_host_ms.serve", "prepare_host_ms.serve", "setup_program_s",
    "idle_in_step_ms.train", "idle_outside_chain_ms.serve"])
def test_reader_reads_nothing_without_the_program_spans(monkeypatch, name):
    """A program without ``utils/tracing.py`` (the import fails) and a trace
    without its spans give None, and no reader raises."""
    monkeypatch.setitem(sys.modules, "causaldiffae_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["causaldiffae_torch.utils"], "tracing")
    bare = Trace(TRACE.device, [e for e in TRACE.host if not e.name.startswith("cdae.")],
                 TRACE.counts, {}, {})
    assert _reader(name)(bare) is None


def test_warm_ms_needs_two_occurrences():
    from benchmark import program

    assert program.warm_ms({"spans": {"cdae.x": _agg(1, 1.0, 1.0)}}, "cdae.x") is None
    assert program.warm_ms(None, "cdae.x") is None
    assert program.warm_ms({"spans": {"cdae.x": _agg(3, 1.0, 0.6)}}, "cdae.x") == pytest.approx(200.0)
