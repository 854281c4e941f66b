"""AdamW with mixed precision: bf16 working params, fp32 master and
moments (counterpart of ``repro.optim.adamw``).

The state mirrors the params tree leaf for leaf.  Every operation is a
plain tensor op in float32, in the reference's order; the reference's
optimizer runs no kernel of its own."""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    master: Any           # fp32 copy of params
    m: Any                # fp32 first moment
    v: Any                # fp32 second moment
    step: torch.Tensor    # 0-d int32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> AdamWState:
    leaf = next(tree_leaves(params))[1]
    return AdamWState(
        master=tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params),
        v=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params),
        step=torch.zeros((), dtype=torch.int32, device=leaf.device))


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf in float32, the leaves
    added in the reference's flatten order (sorted dict keys, list
    order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, cfg: AdamWConfig):
    """Returns (new_bf16_params, new_state).  Grads may be bf16; the math
    is fp32.  Weight decay applies to leaves of two or more dims."""
    step = state.step + 1
    stepf = step.float()
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    lr = cfg.lr * warm

    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(g, mu, nu, p):
        g = g.float() * scale
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * g
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu2 / bc1
        vhat = nu2 / bc2
        step_dir = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            step_dir = step_dir + cfg.weight_decay * p
        return p - lr * step_dir, mu2, nu2

    flat = [upd(g, mu, nu, p) for (_, g), (_, mu), (_, nu), (_, p) in
            zip(tree_leaves(grads), tree_leaves(state.m),
                tree_leaves(state.v), tree_leaves(state.master))]
    new_master = tree_unflatten(grads, [o[0] for o in flat])
    new_m = tree_unflatten(grads, [o[1] for o in flat])
    new_v = tree_unflatten(grads, [o[2] for o in flat])
    new_params = tree_map(lambda x: x.to(torch.bfloat16), new_master)
    return new_params, AdamWState(new_master, new_m, new_v, step)
