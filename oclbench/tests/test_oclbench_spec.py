"""BENCHMARK.json against the benchmark's rules, and every file a cell or a
metric needs found by its name."""

import json
import math

import pytest

from oclbench_cells import ROOT
from oclbench import spec

BENCH = spec.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_benchmark_json_keeps_the_rules():
    assert spec.problems(BENCH, ROOT) == []
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_the_cells_and_metrics():
    assert {w["name"]: (w["config"], w["chips"]) for w in BENCH["workloads"]} == {
        "mini84.aser": ("rrn18_mini84", 1), "cifar100.er_grid84": ("rrn18_cifar100", 1)}
    assert [m["name"] for m in BENCH["end_to_end"]] == ["images_per_s", "step_ms_p95", "setup_s"]
    assert {m["name"] for m in BENCH["per_layer"]} == {
        "step.launches", "step.host_ms", "aser.device_ms", "k1_roofline", "step.mfu",
        "device.idle_pct"}
    assert all(m["moves"] == "images_per_s" for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_finds_its_files(workload):
    cell = spec.Cell(ROOT, BENCH, workload)
    assert (ROOT / "oclbench" / "loops" / (cell.traffic["loop"] + ".py")).is_file()
    assert set(cell.limits) <= {"loss", "grad1", "change1", "change3_median", "picks", "exact"}
    assert all(v >= 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s", "step_ms_p95", "setup_s"}
    assert cell.per_layer and all(callable(spec.reader(m["name"])) for m in cell.per_layer)


@pytest.mark.parametrize("name", METRICS + CELLS + ["rrn18_mini84", "rrn18_cifar100"])
def test_names_keep_the_name_rule(name):
    assert spec.NAME.match(name)


@pytest.mark.parametrize("bad", ["a b", "a/b", "a,b", "-a", "", "x" * 65, "µs"])
def test_the_name_rule_refuses(bad):
    assert not spec.NAME.match(bad)


def test_a_broken_benchmark_is_reported():
    broken = json.loads(json.dumps(BENCH))
    broken["end_to_end"][0]["bound"] = 0.5
    broken["per_layer"][0]["unit"] = "launches per step"
    broken["workloads"][1]["chips"] = 2
    broken["run_seconds"] = 60
    assert len(spec.problems(broken, ROOT)) == 4


def test_a_full_check_fits_its_time_budget_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert math.isclose(next(m["bound"] for m in BENCH["end_to_end"] if m["name"] == "setup_s"),
                        0.25)
