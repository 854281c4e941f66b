"""The harness finds every cell, mix, configuration and metric by name, and
BENCHMARK.json keeps to the shape the benchmark's contract gives it."""

from __future__ import annotations

import json
import re

import pytest

import pbtiny
from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    spec = harness.cell_spec(cell)
    assert spec["chips"] == 1
    assert harness.driver(spec["traffic"]["driver"]).run
    assert spec["limits"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = harness.metric_reader(metric)
    assert read({}) is None        # nothing to read: the metric is left out


def test_entries_keep_the_contract_shape():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.loads((harness.REPO / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    assert len(names) == len(set(names))


def test_every_cell_reports_its_metrics():
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(w["name"])
        moved = {m["moves"] for m in spec["per_layer"]}
        assert moved <= {m["name"] for m in spec["end_to_end"]}


def test_a_dummy_cell_is_found_by_name(tmp_path):
    """A later change adds a cell, a mix, a configuration and a metric by
    adding files and entries only."""
    for d in ("configs", "traffic", "workloads", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "dummy-cfg.json").write_text('{"k": 1}')
    (tmp_path / "traffic" / "dummy-mix.json").write_text(
        '{"driver": "train", "pool_batches": 3}')
    (tmp_path / "workloads" / "dummy-cfg.mix.json").write_text(json.dumps(
        {"config": "dummy-cfg", "traffic": "dummy-mix", "params": {"x": 2},
         "limits": {"gap": 0.5}}))
    (tmp_path / "metrics" / "dummy.metric.py").write_text(
        "def read(rec):\n    return rec.get('x')\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "dummy-cfg.mix", "config": "dummy-cfg",
         "traffic": "dummy-mix", "chips": 1, "why": "test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "dummy.metric", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "engine", "moves": "setup_s",
         "workloads": ["dummy-cfg.mix"]}]
    spec = harness.cell_spec("dummy-cfg.mix", bench=bench, root=tmp_path)
    assert spec["config"] == {"k": 1}
    assert spec["traffic"]["pool_batches"] == 3
    assert spec["params"] == {"x": 2} and spec["limits"] == {"gap": 0.5}
    assert [m["name"] for m in spec["per_layer"]] == ["dummy.metric"]
    assert harness.per_layer_values(spec, {"x": 7.0}, tmp_path) == {
        "dummy.metric": {"value": 7.0, "unit": "%"}}
    assert harness.per_layer_values(spec, {}, tmp_path) == {}


def test_a_workload_file_that_disagrees_is_refused(tmp_path):
    (tmp_path / "workloads").mkdir()
    cell = BENCH["workloads"][0]
    (tmp_path / "workloads" / f"{cell['name']}.json").write_text(json.dumps(
        {"config": "other", "traffic": cell["traffic"], "limits": {}}))
    with pytest.raises(ValueError):
        harness.cell_spec(cell["name"], root=tmp_path)
    with pytest.raises(KeyError):
        harness.cell_spec("no-such.cell")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_tiny_specs_come_from_the_cells_files(cell):
    spec = pbtiny.spec(cell)
    assert spec["traffic"]["driver"] == "train"
    assert spec["limits"] == harness.cell_spec(cell)["limits"]
