"""The readers of the program's record of the traced steps
(``repro_torch.obs``): ``carry_sweep_roofline`` and
``train.host_ms_per_iter`` on a made-up record against sums by hand,
nothing read when the record does not hold exactly the traced steps, and
on a tiny traced run of each cell the record holds its traced slice."""

from __future__ import annotations

import pytest

import pbtiny
from portbench import harness, work
from repro_torch import obs

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _step(i, iters, power_tokens, P=10, Pk=4, tokens=500):
    """A recorded step: its root, ``iters`` pobp.iter spans of 2 ms and
    reads of 5 ms between them."""
    spans = [obs.Span("pobp.step", 0, 10**9, -1, i, 0)]
    t = 1000
    for _ in range(iters):
        spans.append(obs.Span("pobp.read", t, t + 5 * 10**6, 0, i, 0))
        t += 5 * 10**6
        spans.append(obs.Span("pobp.iter", t, t + 2 * 10**6, 0, i, 0))
        spans.append(obs.Span("pobp.sweep", t + 1, t + 10**6,
                              len(spans) - 1, i, 0))
        t += 2 * 10**6
    return obs.Step(i, spans, dict(iters=iters + 1, selective_iters=iters,
                                   tokens=tokens, P=P, Pk=Pk,
                                   power_tokens=power_tokens))


@pytest.fixture()
def record(monkeypatch):
    steps = [_step(0, 3, 300), _step(1, 5, 500)]
    monkeypatch.setattr(obs, "steps", lambda: steps)
    trace = {"kernels": {"(anonymous namespace)::carry_train_kernel<8>":
                         {"s": 2e-3, "launches": 8},
                         "(anonymous namespace)::carry_dr_fold_kernel<8>":
                         {"s": 1e-3, "launches": 8},
                         "bp_update_kernel": {"s": 5.0, "launches": 2}}}
    return {"train": {"traced": [{}, {}]}, "trace": trace}


def test_host_ms_per_iter_by_hand(record):
    read = harness.metric_reader("train.host_ms_per_iter")
    assert read(record) == pytest.approx(2.0)      # 8 spans of 2 ms / 8


def test_carry_sweep_roofline_by_hand(record):
    read = harness.metric_reader("carry_sweep_roofline")
    # 100 power tokens a sweep in both steps, P = 10, Pk = 4, 8 sweeps
    nbytes = 4 * 4 * (2 * 100 + 3 * 10) * 8
    flops = work.OPS_SELECTIVE * 100 * 4 * 8
    least = max(nbytes / work.HBM_BYTES_PER_S, flops / work.F32_FLOPS_PER_S)
    assert read(record) == pytest.approx(100 * least / 3e-3)


@pytest.mark.parametrize("metric",
                         ["carry_sweep_roofline", "train.host_ms_per_iter"])
def test_nothing_is_read_unless_the_record_is_the_traced_slice(record,
                                                               metric):
    read = harness.metric_reader(metric)
    assert read({}) is None
    assert read({"train": {"steps": [{}]}}) is None
    assert read(dict(record, train={"traced": [{}]})) is None
    assert read(dict(record, train={"traced": [{}, {}, {}]})) is None
    assert read(dict(record, train={"traced": []})) is None


def test_the_roofline_needs_the_carry_kernels_in_the_trace(record):
    read = harness.metric_reader("carry_sweep_roofline")
    assert read(dict(record, trace=None)) is None
    assert read(dict(record, trace={"kernels": {
        "bp_update_kernel": {"s": 5.0, "launches": 2}}})) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_records_its_traced_slice(cell):
    rec = pbtiny.run(cell, trace_on=True)
    steps = obs.steps()
    assert len(steps) == len(rec["train"]["traced"]) > 0
    c = pbtiny.spec(cell)["config"]
    P = max(1, int(round(c["lambda_w"] * c["vocab_size"])))
    for s, t in zip(steps, rec["train"]["traced"]):
        c = s.counters
        assert c["iters"] == t["iters"] and c["P"] == P
        assert c["selective_iters"] == c["iters"] - 1
        if c["selective_iters"]:
            assert 0 < c["power_tokens"] <= c["tokens"] * c["selective_iters"]
    ms = harness.metric_reader("train.host_ms_per_iter")(rec)
    assert ms is not None and ms > 0
    # the CPU run has no device trace: no carry kernel time to divide by
    assert harness.metric_reader("carry_sweep_roofline")(rec) is None
