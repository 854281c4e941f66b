"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
own files with the sizes cut, so a run takes seconds on the host."""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import harness  # noqa: E402

SEED = 2**31 + 11      # past 32 signed bits, as the driver's seeds are


def spec(cell: str) -> dict:
    """Cell ``cell``'s spec at a size a CPU test holds."""
    s = harness.cell_spec(cell)
    s["config"] = dict(s["config"], vocab_size=600, num_topics=16,
                       minibatch_docs=24, doc_slots=16, lambda_k_abs=4,
                       inner_iters=30)
    s["traffic"] = dict(s["traffic"], pool_batches=3, doc_len_mean=12)
    s["params"] = dict(s["params"], trace_seconds=0.2)
    return s


def run(cell: str, *, seconds: float = 0.3, trace_on: bool = False,
        seed: int = SEED, **kw) -> dict:
    """One run of the tiny cell on the CPU through its driver."""
    s = spec(cell)
    return harness.driver(s["traffic"]["driver"]).run(
        s, seed=seed, seconds=seconds, trace_on=trace_on, device="cpu",
        t_start=time.time(), **kw)
