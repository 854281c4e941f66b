"""Tiny versions of the benchmark's LM cells for the CPU tests: the cells'
own files with the widths, depth, vocabulary and batch cut, so a run takes
seconds on the host."""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import harness  # noqa: E402

SEED = 2**31 + 11      # past 32 signed bits, as a benchmark run's may be
CELLS = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.cell_spec(w["name"])["traffic"]["driver"] == "lm_train"]

SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=128, moe_intermediate_size=32,
             n_routed_experts=16, experts_held=4, n_layers=3, vocab_size=256)


def spec(cell: str) -> dict:
    """Cell ``cell``'s spec at a size a CPU test holds."""
    s = harness.cell_spec(cell)
    s["config"] = dict(s["config"], **SMALL)
    s["traffic"] = dict(s["traffic"], batch=2, seq=32, pool_batches=3)
    s["params"] = dict(s["params"], trace_seconds=0.2)
    return s


def run(cell: str, *, seconds: float = 0.3, trace_on: bool = False,
        seed: int = SEED, **kw) -> dict:
    """One run of the tiny cell on the CPU through its driver."""
    s = spec(cell)
    return harness.driver(s["traffic"]["driver"]).run(
        s, seed=seed, seconds=seconds, trace_on=trace_on, device="cpu",
        t_start=time.time(), **kw)
