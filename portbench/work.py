"""The yardstick's arithmetic: the card's peaks and the work that the
algorithm needs on given inputs, whatever implements it.

Each input is read once and each output the algorithm needs is written
once; what today's kernels write beyond that (the dense sweep's [T, K]
residual, the padding slots of a mini-batch) is not counted, so the work
of an input stays the same after any later kernel change and a share
above 100% can only mean a fault.  A "token" is a counted slot: one
distinct word of one document, with its count.  Time bounds are the
larger of bytes over the memory rate and float32 operations over the
float32 rate of NVIDIA's H100 SXM data sheet (700 W).

Corrected from the bound functions of ``chip_smoke.py`` (``bp_bound_ms``,
``sweep_bound_ms``, ``carry_train_bound_ms``), which count what the
kernels of the day write.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet: HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet: float32, no tensor cores
F32 = 4                        # bytes a float32
# float32 operations a message element takes at least: the three
# self-excluded factors, their product and quotient, the normalizer's sum
# and scale, and the residual's difference
OPS_DENSE = 8
OPS_SELECTIVE = 8


class Work(NamedTuple):
    nbytes: float
    flops: float

    def __add__(self, other):
        return Work(self.nbytes + other.nbytes, self.flops + other.flops)

    def scaled(self, n: float) -> "Work":
        return Work(self.nbytes * n, self.flops * n)

    def least_s(self) -> float:
        """The least time the card could take for this work."""
        return max(self.nbytes / HBM_BYTES_PER_S,
                   self.flops / F32_FLOPS_PER_S)


ZERO = Work(0.0, 0.0)


def dense_sweep(tokens: int, words: int, docs: int, K: int) -> Work:
    """The dense t = 1 sweep (Fig. 4 lines 3-8): the messages at the
    counted tokens read and written, the residual summed per distinct word
    written, the distinct phi rows and the documents' theta rows read."""
    return Work(F32 * K * (2 * tokens + 2 * words + docs),
                OPS_DENSE * tokens * K)


def step_output(words: int, K: int) -> Work:
    """The new statistic's rows of the mini-batch's distinct words, written
    once (Eq. 11)."""
    return Work(F32 * K * words, 0.0)


def selective_iteration(power_tokens: int, P: int, Pk: int) -> Work:
    """One selective sweep (Fig. 4 lines 15-24): the messages of the power
    tokens at their Pk topics read and written, the [P, Pk] phi pack read,
    the [P, Pk] delta and residual written."""
    return Work(F32 * Pk * (2 * power_tokens + 3 * P),
                OPS_SELECTIVE * power_tokens * Pk)


def min_power_tokens(tokens_per_word, P: int) -> int:
    """A lower bound on the power tokens of one selective iteration: the
    counted tokens of the ``P`` present words that have the fewest (all of
    them when fewer than P words are present).  ``tokens_per_word`` holds
    the counted tokens of each present word (a list, or a tensor on any
    device)."""
    n = torch.as_tensor(tokens_per_word, dtype=torch.int64)
    return int(torch.sort(n).values[:P].sum())


def train_step(*, tokens: int, words: int, docs: int, K: int,
               iters: int, power_tokens_min: int, P: int, Pk: int) -> Work:
    """One POBP mini-batch that ran ``iters`` iterations (the dense one
    included)."""
    return (dense_sweep(tokens, words, docs, K) + step_output(words, K)
            + selective_iteration(power_tokens_min, P, Pk).scaled(
                max(0, iters - 1)))
