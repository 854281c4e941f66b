"""The reader of ``power_topics_roofline`` on a made-up record against a
sum by hand, and left out where the program has no such kernel or its
record no ``K`` (a parent without the selection kernel)."""

from __future__ import annotations

import pytest

import pbtiny  # noqa: F401  (puts the checkout's src on the path)
from portbench import harness, work
from repro_torch import obs


def _step(i, selective, **counters):
    spans = [obs.Span("pobp.step", 0, 10**9, -1, i, 0)]
    base = dict(iters=selective + 1, selective_iters=selective, tokens=500,
                power_tokens=100 * selective, P=10, Pk=4, K=64)
    return obs.Step(i, spans, {**base, **counters})


KERNEL = "void (anonymous namespace)::power_topics_kernel<true>(...)"


@pytest.fixture()
def record(monkeypatch):
    steps = [_step(0, 3), _step(1, 5)]
    monkeypatch.setattr(obs, "steps", lambda: steps)
    trace = {"kernels": {KERNEL: {"s": 2e-6, "launches": 8},
                         "carry_train_kernel": {"s": 1e-3, "launches": 8}}}
    return {"train": {"traced": [{}, {}]}, "trace": trace}


def test_power_topics_roofline_by_hand(record):
    read = harness.metric_reader("power_topics_roofline")
    nbytes = 8 * 4 * 10 * (64 + 1 + 4)            # 8 selections of 10 rows
    want = 100 * nbytes / work.HBM_BYTES_PER_S / 2e-6
    assert read(record) == pytest.approx(want)


def test_left_out_without_the_kernel_or_the_row_width(record, monkeypatch):
    read = harness.metric_reader("power_topics_roofline")
    assert read(dict(record, trace={"kernels": {
        "gatherTopK": {"s": 1.0, "launches": 8}}})) is None
    assert read(dict(record, trace=None)) is None
    assert read(dict(record, train={"traced": [{}]})) is None
    old = [_step(0, 3), _step(1, 5)]
    for s in old:
        del s.counters["K"]
    monkeypatch.setattr(obs, "steps", lambda: old)
    assert read(record) is None


def test_left_out_without_a_selective_iteration(record, monkeypatch):
    monkeypatch.setattr(obs, "steps", lambda: [_step(0, 0), _step(1, 0)])
    assert harness.metric_reader("power_topics_roofline")(record) is None
