"""Faults planted underneath the LM cells' timed path, so that the
correctness check's power to fail is shown (the CPU tests) and read on the
card at the cell's own size (``lm_calibrate.py --fault``).  Never used by
a benchmark run.

  - ``yarn``: YaRN left out (plain RoPE and softmax scale);
  - ``renorm``: the top-k gates renormalised to sum 1;
  - ``no_shared``: the shared experts left out;
  - ``expert``: the first held expert's output zeroed;
  - ``capacity``: a capacity queue at factor 1.0 in place of the dropless
    layer (tokens past an expert's capacity dropped);
  - ``adamw_lr``: AdamW's rate 10% high;
  - ``adamw_decay``: AdamW's weight decay left out;
  - ``adamw_master``: AdamW updating from the bf16 params, in place of its
    float32 master copy.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("yarn", "renorm", "no_shared", "expert", "capacity", "adamw_lr",
          "adamw_decay", "adamw_master")


def _broken(cfg, fault: str):
    moe = cfg.moe
    if fault == "yarn":
        return dataclasses.replace(cfg, rope_scaling=None)
    if fault == "renorm":
        moe = dataclasses.replace(moe, norm_topk_prob=True)
    elif fault == "no_shared":
        moe = dataclasses.replace(moe, num_shared=0)
    elif fault == "capacity":
        moe = dataclasses.replace(moe, dropless=False, capacity_factor=1.0)
    return dataclasses.replace(cfg, moe=moe)


@contextlib.contextmanager
def _first_expert_zeroed():
    """The dropless layer's third product (the experts' outputs) with the
    first held expert's rows zeroed, in the forward and its run again."""
    from repro_torch.models import moe

    real, calls = moe._grouped, [0]

    def grouped(a, w, ends):
        out = real(a, w, ends)
        calls[0] += 1
        if calls[0] % 3 == 0:
            first = torch.arange(out.shape[0], device=out.device) < ends[0]
            out = torch.where(first[:, None], 0, out)
        return out
    moe._grouped = grouped
    try:
        yield
    finally:
        moe._grouped = real


def _optimizer(acfg, fault: str):
    if fault == "adamw_lr":
        return dataclasses.replace(acfg, lr=acfg.lr * 1.1)
    if fault == "adamw_decay":
        return dataclasses.replace(acfg, weight_decay=0.0)
    return acfg


@contextlib.contextmanager
def _no_master():
    """AdamW's update taken from its master copy rounded to bf16 (the
    params), as if it kept none."""
    from repro_torch.launch import train
    from repro_torch.models.common import tree_map

    real = train.adamw_update

    def update(grads, state, cfg):
        return real(grads, state._replace(master=tree_map(
            lambda x: x.to(torch.bfloat16).float(), state.master)), cfg)
    train.adamw_update = update
    try:
        yield
    finally:
        train.adamw_update = real


def _planted(fault: str):
    if fault == "expert":
        return _first_expert_zeroed()
    if fault == "adamw_master":
        return _no_master()
    return contextlib.nullcontext()


def train_program(fault: str, from_step: int = 0):
    """A trainer maker like ``launch.train.build_trainer`` whose step has
    ``fault`` from its call ``from_step`` (counted from 0) on."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    from repro_torch.launch.train import build_trainer

    def make(cfg, acfg, *args):
        good, meter, mod = build_trainer(cfg, acfg, *args)
        bad = build_trainer(_broken(cfg, fault), _optimizer(acfg, fault),
                            *args)[0]
        calls = [0]

        def step(*a):
            calls[0] += 1
            if calls[0] <= from_step:
                return good(*a)
            with _planted(fault):
                return bad(*a)
        return step, meter, mod
    return make
