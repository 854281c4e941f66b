"""The work counts that the shares of the peak rest on, against values
counted by hand at small shapes."""

from __future__ import annotations

import pytest
import torch

import pbtiny  # noqa: F401  (puts the checkout on the path)
from portbench import work
from portbench.drivers.train import _batch_counts


def test_dense_sweep_counts_what_the_algorithm_needs():
    # 2 documents x 4 slots, K = 3: doc 0 has words 5, 7 (counts 2, 1) and
    # two padding slots; doc 1 has words 5, 9, 11, 7 (counts 1, 1, 3, 1)
    wid = torch.tensor([[5, 7, 0, 0], [5, 9, 11, 7]], dtype=torch.int32)
    cnt = torch.tensor([[2., 1., 0., 0.], [1., 1., 3., 1.]])
    n = _batch_counts(wid, cnt, P=2)
    assert (n["tokens"], n["words"], n["docs"]) == (6, 4, 2)
    assert n["counted_tokens"] == 9.0
    assert n["rows"].tolist() == [5, 7, 9, 11]
    # the two present words with the fewest counted tokens: 9 and 11
    assert n["power_tokens_min"] == 2
    K = 3
    w = work.dense_sweep(n["tokens"], n["words"], n["docs"], K)
    # mu read and written at 6 counted tokens, the residual of 4 words
    # written, 4 phi rows and 2 theta rows read: (12 + 8 + 2) x 3 floats
    assert w.nbytes == 4 * 3 * (12 + 8 + 2)
    assert w.flops == 8 * 6 * 3
    # not counted: the 2 padding slots and the [T, K] residual of today's
    # bp_update (what a count of T = 8 slots would give)
    T = wid.numel()
    assert w.nbytes < 4 * K * (2 * T + T + 4 + 2)


def test_selective_and_step_counts():
    it = work.selective_iteration(power_tokens=10, P=3, Pk=2)
    assert it.nbytes == 4 * 2 * (20 + 9)
    assert it.flops == 8 * 10 * 2
    step = work.train_step(tokens=6, words=4, docs=2, K=3, iters=4,
                           power_tokens_min=2, P=2, Pk=2)
    want = (work.dense_sweep(6, 4, 2, 3) + work.step_output(4, 3)
            + work.selective_iteration(2, 2, 2).scaled(3))
    assert step == want
    assert work.step_output(4, 3).nbytes == 4 * 3 * 4
    # one iteration (the dense one alone): no selective sweep
    assert work.train_step(tokens=6, words=4, docs=2, K=3, iters=1,
                           power_tokens_min=2, P=2,
                           Pk=2) == work.dense_sweep(6, 4, 2, 3) + \
        work.step_output(4, 3)


def test_min_power_tokens():
    assert work.min_power_tokens([5, 1, 3, 1], 2) == 2
    assert work.min_power_tokens([5, 1], 4) == 6


def test_min_power_tokens_of_a_device_tensor():
    n = torch.tensor([7, 2, 2, 9, 1])
    assert work.min_power_tokens(n, 3) == 5
    assert work.min_power_tokens(n, 9) == 21


def test_least_time():
    w = work.Work(3.35e12, 0.0)
    assert w.least_s() == pytest.approx(1.0)
    assert work.Work(0.0, 67e12).least_s() == pytest.approx(1.0)
