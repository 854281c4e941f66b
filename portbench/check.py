"""How ``correct`` is decided: the program's outputs from the timed path
against the plain reference (``portbench/reference``), each number beside
its limit (the cell's workload file, ``limits``).

Training (per checked step: the set-up steps, the reference following them
from the same model, batches and random fields; and the step that closed
the window, the reference following it from the statistic it started
from):

  - ``phi_gap``: sum over the batch's words of |phi_acc_prog - phi_acc_ref|
    over the sum of |phi_acc_ref - phi_acc_ref before the step| (the
    batch's delta), the largest over the checked steps;
  - ``theta_gap``: the largest L1 distance between a document's normalized
    theta from the program and from the reference;
  - ``untouched_changed``: rows outside the batch's words that the step
    changed (exactly 0).

A number passes when it is at most its limit.
"""

from __future__ import annotations

from typing import Dict

import torch


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    compared = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
                for k in limits}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return {"correct": ok, "compared": compared}


def theta_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row, the L1 distance of the two rows normalized to sum 1."""
    a = a.double()
    b = b.double()
    return (a / a.sum(dim=1, keepdim=True)
            - b / b.sum(dim=1, keepdim=True)).abs().sum(dim=1)


def train_step_numbers(kept: dict, prev: torch.Tensor, new: torch.Tensor,
                       theta: torch.Tensor) -> dict:
    """The training numbers of one checked step: the program's kept
    outputs against the reference's (phi_acc_new, theta), ``prev`` the
    reference's statistic before the step."""
    rows = kept["rows"].to(new.device)
    want = new[rows].double()
    delta = (want - prev[rows].double()).abs().sum()
    gap = (kept["phi_rows"].to(new.device).double() - want).abs().sum()
    return {"phi_gap": float(gap / delta.clamp_min(1e-300)),
            "theta_gap": float(theta_l1(kept["theta"].to(new.device),
                                        theta).max()),
            "untouched_changed": int(kept["untouched_changed"])}


def worst(steps: list) -> dict:
    """Each number's worst over the checked steps (the sum for a count)."""
    return {"phi_gap": max(s["phi_gap"] for s in steps),
            "theta_gap": max(s["theta_gap"] for s in steps),
            "untouched_changed": sum(s["untouched_changed"] for s in steps)}

