"""BENCHMARK.json against the contract's form, and the harness finding
each configuration, traffic mix, driver and metric by its name."""
import json
import re

import pytest

from benchmark import core

SPEC = core.Spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC.data) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert SPEC.data["command"] == ["python3", "benchmark/run.py"]
    assert SPEC.data["paths"] == ["benchmark"]
    assert 1 <= SPEC.data["run_seconds"] <= 51
    assert len(json.dumps(SPEC.data)) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC.data["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("benchmark/")
    loaded = SPEC.config(cfg["name"])
    assert loaded["width"] == 128 and loaded["reduced"] == cfg["reduced"]
    assert any(c["config"] == cfg["name"] for c in SPEC.data["workloads"])


@pytest.mark.parametrize("cell", SPEC.data["workloads"],
                         ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    traffic = SPEC.traffic(cell["traffic"])
    assert (core.BENCH / "drivers" / f"{traffic['driver']}.py").exists()
    assert hasattr(core.driver_class(traffic["driver"]), "check")
    e2e = [m["name"] for m in SPEC.metrics("end_to_end", cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SPEC.metrics("per_layer", cell["name"])


def test_metrics_form_and_readers():
    e2e = {m["name"]: m for m in SPEC.data["end_to_end"]}
    cells = {c["name"] for c in SPEC.data["workloads"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC.data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    layers = set()
    for m in SPEC.data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # the metric it moves is reported in each of its cells
        assert all(c in e2e[m["moves"]].get("workloads", cells)
                   for c in m["workloads"])
        assert callable(core.metric_reader(m["name"]))
        layers.add(m["layer"])
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert {"collate", "landmark model", "solver", "trainer", "kernels",
            "device"} <= layers


def test_metric_reader_finds_nothing_without_a_trace():
    run = core.Run(trace=True)
    for m in SPEC.data["per_layer"]:
        assert core.metric_reader(m["name"])(run) is None
