"""The power-topic selection's wrapper (``kernels/power_topics/ops.py``) on
the CPU: its launch plan from the row width, the shapes it refuses, the
plain version's order on rows whose ties the float total order splits,
and its place in the launch registry.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``); against the reference's ``lax.top_k``
see ``tests/test_torch_pobp.py``.  The file imports neither ``jax`` nor
``repro``."""

import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.power_topics import ops


@pytest.mark.parametrize("K,Pk,threads", [(1, 1, 32), (8, 8, 32),
                                          (10, 1, 32), (600, 50, 64),
                                          (2000, 50, 128), (4096, 50, 256),
                                          (10000, 50, 512), (20001, 50, 512)])
def test_launch_plan_follows_the_row_width(K, Pk, threads):
    plan = ops.topics_launch_plan(K, Pk)
    assert plan.threads == threads
    assert plan.keys_per_thread * plan.threads >= K
    # the keys, two 10-bit histograms, 256 candidates' ids and composites
    assert plan.smem_bytes == 4 * (K + 2 * 1024 + max(256, -(-Pk // 4) * 4)
                                   ) + 8 * 256


@pytest.mark.parametrize("K,Pk", [(10, 0), (10, 11), (0, 1)])
def test_launch_plan_refuses_pk_outside_one_to_k(K, Pk):
    with pytest.raises(ValueError, match="1 <= Pk <= K"):
        ops.topics_launch_plan(K, Pk)


def test_wrapper_refuses_a_device_it_has_no_route_for():
    r = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.power_topics(r, torch.zeros(2, dtype=torch.int32, device="meta"),
                         3)


def test_plain_version_splits_signed_zeros_and_ties_by_id():
    r = torch.tensor([[0.0, -0.0, 1.0, -1.0, 1.0, 0.0, -0.0, 2.0],
                      [-0.0, 0.0, -0.0, 0.0, -2.0, -1.0, -2.0, -1.0]])
    got = ops.power_topics(r, torch.tensor([1, 0, 1], dtype=torch.int32), 8)
    assert got.dtype == torch.int32
    assert got.tolist() == [[1, 3, 0, 2, 5, 7, 4, 6],
                            [7, 2, 4, 0, 5, 1, 6, 3],
                            [1, 3, 0, 2, 5, 7, 4, 6]]


def test_the_kernel_is_in_the_launch_registry():
    counts = launch_counts()
    assert "power_topics" in counts
    ops.power_topics(torch.rand(5, 7), torch.arange(5, dtype=torch.int32), 3)
    assert launch_counts()["power_topics"] == counts["power_topics"]
