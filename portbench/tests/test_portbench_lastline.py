"""The result line holds only the contract's keys, in its order, with the
numbers compared last."""

from __future__ import annotations

import json

import pytest

import pbtiny
from portbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _line(cell, trace_on):
    rec = pbtiny.run(cell, trace_on=trace_on)
    rec["device"] = {"platform": "gpu", "kind": "test", "count": 1,
                     "memory_peak_bytes": 1}
    return harness.result_line(pbtiny.spec(cell), rec, trace_on), rec


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(cell):
    line, rec = _line(cell, False)
    assert list(line) == KEYS + ["compared"]
    spec = pbtiny.spec(cell)
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["correct"] is True and line["failed"] == 0
    assert rec["notes"][0].startswith("set-up ")
    for phase in ("start_imports_context", "model", "documents", "first_step",
                  "checked_steps"):
        assert f" {phase} " in rec["notes"][0]
    assert rec["notes"][1].startswith("kernels")
    assert rec["notes"][2].startswith("window ")
    for name, c in line["compared"].items():
        assert set(c) == {"value", "limit"}
        assert name in spec["limits"]
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    line, rec = _line(cell, True)
    assert list(line) == KEYS + ["breakdown", "compared"]
    spec = pbtiny.spec(cell)
    per_layer = {m["name"] for m in spec["per_layer"]}
    # the CPU run has no device trace: the device readers find nothing
    assert set(line["metrics"]) <= per_layer
    assert set(line["metrics"]) >= {m for m in per_layer
                                    if "idle" not in m
                                    and "roofline" not in m}
    b = line["breakdown"]
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_device_events_and_gaps_are_read():
    """The trace reader on made-up events: the benchmark's ranges and their
    device copies are not device work; gaps are named by the span the
    host was in."""
    from torch.autograd import DeviceType

    class E:
        def __init__(self, name, s, e, dev):
            self.name = name
            self.device_type = dev
            self.time_range = type("R", (), {"start": s, "end": e})()

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [E("pb.train.step", 0, 100, cpu),
              E("pb.train.step", 0, 100, cuda),
              E("pb.train.read", 100, 200, cpu), E("k1", 10, 40, cuda),
              E("k2", 30, 60, cuda), E("k1", 150, 170, cuda),
              E("aten::add", 5, 6, cpu)]
    from portbench import trace
    r = trace.read_events(events, 0.0)
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(70e-6)
    assert r["kernels"]["k1"] == {"s": pytest.approx(50e-6), "launches": 2}
    assert "pb.train.step" not in r["kernels"]
    gaps = dict(r["breakdown"]["idle_gaps"])
    # gaps [0, 10] (host in the step), [60, 150] and [170, 200] (in the
    # read at their middles)
    assert gaps["pb.train.step"] == pytest.approx(10e-6)
    assert gaps["pb.train.read"] == pytest.approx(120e-6)
