"""Faults planted underneath the timed path, so that the correctness
check's power to fail is shown (the CPU tests) and read on the card at a
cell's own size (``calibrate.py --fault``).  Never used by a benchmark
run.

  - ``unchanged``: a training step that returns its state unchanged;
  - ``half``: half of the mini-batch left out (its theta the mean of the
    rest's);
  - ``token``: an answer altered where it is produced (a document's theta
    shifted by one topic).

The exchange between cards cannot be left out: every cell runs on one.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half", "token")


def train_program(fault: str, from_step: int = 0):
    """A step maker like ``make_train_step`` whose step has ``fault``
    from its call ``from_step`` (counted from 0) on."""
    from repro_torch.core.pobp import make_train_step

    def make(cfg, **kw):
        step, meter = make_train_step(cfg, **kw)
        calls = [0]

        def broken(state, word_ids, counts):
            calls[0] += 1
            if calls[0] <= from_step:
                return step(state, word_ids, counts)
            if fault == "half":
                D = word_ids.shape[0]
                new, diag = step(state, word_ids[:D // 2], counts[:D // 2])
                th = diag["theta"]
                diag["theta"] = torch.cat(
                    [th, th.mean(dim=0, keepdim=True).expand(D - D // 2, -1)])
                return new, diag
            new, diag = step(state, word_ids, counts)
            if fault == "unchanged":
                return state, diag
            diag["theta"][0] = diag["theta"][0].roll(1)
            return new, diag
        return broken, meter
    return make
