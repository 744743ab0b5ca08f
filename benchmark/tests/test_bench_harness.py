"""The harness on the CPU: discovery by name, the faults and the control,
and what the command and the reference import."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import calibrate, pool
from benchmark import run as RUN

from . import tiny

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 33 + 7    # beyond 32 bits: seeds may be that large
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]

TOY_GENERATOR = '''
import time
import torch


def run(r):
    r.open_window()
    t0, steps = time.perf_counter(), 0
    counts = {"steps": 2}
    with r.profiled(counts):
        for _ in range(2):
            with r.span("bench.step"):
                torch.ones(8).sum()
            steps += 1
    r.close_window()
    return {"attempted": steps, "failed": 0, "numbers": {"toy_gap": 0.0},
            "e2e": {"toy_rate": steps / (time.perf_counter() - t0)}, "host": {"toy": 7.0}}
'''

TOY_METRIC = '''
def read(trace):
    return trace.counts["toy"] + trace.counts["steps"]
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_a_new_cell_is_found_and_run_by_name(tmp_path):
    """A configuration, a traffic kind with its generator, a cell, its limits
    and a per-layer metric, all added as files, run with no edit."""
    root = tiny.make_root(tmp_path)
    b = root / "benchmark"
    (b / "configs" / "toy.json").write_text(json.dumps(tiny.CONFIGS["tiny_morpho"]))
    (b / "traffic" / "toy_mix.json").write_text(json.dumps({"generator": "toy", "batch": 1}))
    (b / "generators" / "toy.py").write_text(TOY_GENERATOR)
    (b / "metrics" / "toy_metric.py").write_text(TOY_METRIC)
    (b / "limits" / "toy_cell.json").write_text(json.dumps({"toy_gap": 0.1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "toy", "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy", "traffic": "toy_mix",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "steps/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["toy_cell"]})
    bench["per_layer"].append({"name": "toy_metric", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = RUN.run_cell("toy_cell", SEED, 1.0, False, "cpu", root=root)
    assert plain["correct"] and set(plain["metrics"]) == {"toy_rate", "setup_s"}
    traced = RUN.run_cell("toy_cell", SEED, 1.0, True, "cpu", root=root)
    assert traced["metrics"] == {"toy_metric": {"value": 9.0, "unit": "count"}}
    assert list(traced)[-1] == "checks"


def test_the_tiny_root_of_the_two_pendulum_cells_is_unchanged(tmp_path):
    """From the benchmark as it stood with its two pendulum cells, the tiny
    root's BENCHMARK.json is, byte for byte, the one written when the cell
    lists were renamed by a fixed table."""
    root = tiny.make_root(tmp_path, DATA / "two_cells.json")
    assert (root / "BENCHMARK.json").read_text() == (DATA / "two_cells.tiny.json").read_text()


def test_a_cell_added_as_data_joins_existing_metrics(tmp_path, root):
    """A MorphoMNIST counterfactual cell added to the repo's BENCHMARK.json
    by entries and list items alone: the tiny root builds from it, and the
    tiny serving cell runs correct with the metrics it reports without it."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = "morpho_cf_dpm25_b16"
    if "morphomnist_causaldae" not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": "morphomnist_causaldae", "source": "morpho",
                                 "file": "benchmark/configs/morphomnist_causaldae.json",
                                 "reduced": [], "why": "morpho"})
    if cell not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": cell, "config": "morphomnist_causaldae",
                                   "traffic": "cf_dpm25_b16", "chips": 1, "why": "morpho"})
    joined = {"cf_latency_p90_s", "launches_per_unet_call.serve", "attn_roofline.serve"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in joined and cell not in m["workloads"]:
            m["workloads"].append(cell)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    added = tiny.make_root(tmp_path / "added", path)
    assert (json.loads((added / "BENCHMARK.json").read_text())
            == json.loads((root / "BENCHMARK.json").read_text()))
    res = RUN.run_cell(tiny.SERVE, SEED, 1.0, False, "cpu", root=added)
    assert res["correct"], res["checks"]
    today = RUN.Run(tiny.SERVE, SEED, 1.0, False, "cpu", root=root).end_to_end()
    assert set(res["metrics"]) == {m["name"] for m in today} >= {"cf_latency_p90_s", "setup_s"}


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
def test_sound_run_is_correct(root, cell):
    res = RUN.run_cell(cell, SEED, 1.0, False, "cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell, fault", [
    (tiny.TRAIN, "half_batch"), (tiny.TRAIN, "state_unchanged"),
    (tiny.SERVE, "answer_altered"), (tiny.SERVE, "step_unchanged"),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    """The run, with the chip's look skipped and a fault planted under the
    timed path, comes out not correct."""
    res = RUN.run_cell(cell, SEED, 1.0, False, "cpu", root=root, fault=fault)
    assert not res["correct"], res["checks"]


def _feed(data, rows):
    return {k: v[rows].copy() for k, v in data.items()}


@pytest.mark.parametrize("fault, wrong", [
    (None, 0),
    ("renormalised", 4),    # the images mapped to [-1, 1] on the way
    ("label", 1),           # one row's c is another row's
    ("repeated", 1),        # the second batch holds a row the first held
    ("no_class", 4),        # the classes left out
])
def test_the_feed_is_held_to_the_pool(fault, wrong):
    """The reference takes the pool's own rows, found by content, and counts
    every row the feed gave the port that is no distinct row of the pool."""
    gen = RUN.load_module(REPO / "benchmark" / "generators" / "train.py", "_bench_gen_train")
    data = pool.image_pool(11, 8, {"image_size": 4, "in_channels": 2, "n_vars": 2,
                                   "class_cond": True}, signed=False)
    kept = [_feed(data, [3, 1]), _feed(data, [0, 5])]
    if fault == "renormalised":
        for b in kept:
            b["image"] = b["image"] * 2 - 1
    elif fault == "label":
        kept[0]["c"][1] = data["c"][2]
    elif fault == "repeated":
        kept[1] = _feed(data, [0, 3])
    elif fault == "no_class":
        for b in kept:
            del b["y"]
    rows, bad = gen.feed_rows(data, kept)
    assert bad == wrong
    if fault is None:
        for got, want in zip(rows, kept):
            assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
def test_the_control_is_not_correct(root, cell, capsys):
    """The reference one precision below the configuration's (fp8 for
    bf16), in the port's place, fails at least one limit."""
    calibrate.main(["--workload", cell, "--seeds", "5", "--fault-seeds", "0", "--device", "cpu"],
                   root)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    control = next(r for r in rows if r.get("kind") == "control")
    limits = tiny.LIMITS[cell]
    assert any(control[k] > v for k, v in limits.items()), (control, limits)


FORBIDDEN = {"jax", "jaxlib", "flax", "causaldiffae_tpu"}


def _top_level_after(code: str, cwd: Path) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(root):
    """A whole run of each cell's generator, in a fresh process, leaves no
    module whose top-level name is JAX's or the JAX package's."""
    code = (f"from pathlib import Path\nfrom benchmark import run as R\n"
            f"for c in ({tiny.TRAIN!r}, {tiny.SERVE!r}):\n"
            f"    R.run_cell(c, 3, 0.5, False, 'cpu', root=Path({str(root)!r}))")
    loaded = _top_level_after(code, REPO)
    assert "causaldiffae_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    loaded = _top_level_after("import benchmark.reference.model, benchmark.reference.train, "
                              "benchmark.reference.chain, benchmark.counts", REPO)
    assert not loaded & (FORBIDDEN | {"causaldiffae_torch"})
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {"causaldiffae_torch"})


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """The command itself on a card, a short window: exit 0, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
