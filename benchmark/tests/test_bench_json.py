"""BENCHMARK.json against the files it names: a cell, configuration or
metric added as data that forgets a file or a list fails here, on the CPU."""

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _reports(metric: dict, cell: str) -> bool:
    """The harness's rule: a metric without a list is every cell's."""
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_listed_name_is_a_cell(metric):
    assert set(metric.get("workloads", [])) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    w = CELLS[cell]
    config = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert (REPO / config["file"]).is_file()
    traffic = REPO / "benchmark" / "traffic" / f"{w['traffic']}.json"
    generator = json.loads(traffic.read_text())["generator"]
    assert (REPO / "benchmark" / "generators" / f"{generator}.py").is_file()
    assert (REPO / "benchmark" / "limits" / f"{cell}.json").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_a_metric_besides_setup(cell):
    mine = {n for n, m in E2E.items() if _reports(m, cell)}
    assert "setup_s" in mine and mine - {"setup_s"}
    assert any(cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in mine)
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader_and_moves_what_its_cells_report(metric):
    assert (REPO / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    assert metric["moves"] in E2E
    for cell in metric.get("workloads", []):
        assert _reports(E2E[metric["moves"]], cell), cell


def test_chips_per_cell():
    chips = [w["chips"] for w in CELLS.values()]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)
