"""Mixture-of-experts FFN: top-k routing, capacity-based dispatch
(counterpart of ``repro.models.moe``, its local path).

Each row (batch element) has its own expert queues: a token's k choices,
taken in row-major (token, choice) order, get queue positions from a
cumulative count; a choice at position >= capacity is dropped (its
residual path still carries the token).  The expert GEMMs process E*C
slots per row.  Router aux (load-balance) loss follows Switch/GShard:
E * sum_e f_e * P_e.

The reference's expert-parallel island (``_moe_apply_manual`` under
``shard_map``) waits for the port's sharding module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Draw, dense_init
from repro_torch.models.mlp import mlp_apply, mlp_params


def moe_params(draw: Draw, cfg: ArchConfig):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_expert
    p = {
        "wr": dense_init(draw, D, E, dtype=torch.float32),
        "wi": draw.normal((E, D, Fe), D ** -0.5),
        "wg": draw.normal((E, D, Fe), D ** -0.5),
        "wo": draw.normal((E, Fe, D), Fe ** -0.5),
    }
    if m.num_shared:
        p["shared"] = mlp_params(draw, D, m.num_shared * Fe, act="silu")
    return p


def capacity(S: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(S * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-c // 8) * 8)


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis and their indices, ties
    to the lower index (as ``jax.lax.top_k``; ``torch.topk`` does not
    promise an order among ties)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_apply(p, x, *, cfg: ArchConfig):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar): the reference's
    ``_moe_apply_local``, with both of its combines."""
    B, S, D = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    C = capacity(S, cfg)

    logits = x.float() @ p["wr"]
    gates = torch.softmax(logits, -1)                           # [B, S, E]
    topv, topi = top_k(gates, k)                                # [B, S, k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- aux load-balance loss (Switch form) ----
    me = gates.mean((0, 1))                                     # P_e
    ce = F.one_hot(topi[..., 0], E).float().mean((0, 1))        # f_e (top-1)
    aux = E * (me * ce).sum()

    # ---- per-row positions in each expert queue ----
    choice_e = topi.reshape(B, S * k)                           # row-major
    onehot = F.one_hot(choice_e, E)                             # [B, S*k, E]
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)
    slot = torch.where(pos < C, choice_e * C + pos, E * C)      # E*C: dropped

    # ---- dispatch: kept slots are unique within a row, so a scatter of
    # the token copies is the reference's scatter-add; the dropped ones
    # all land on row E*C, which is sliced away ----
    xt = x.repeat_interleave(k, dim=1)                          # [B, S*k, D]
    disp = x.new_zeros((B, E * C + 1, D))
    disp.scatter_(1, slot[..., None].expand(B, S * k, D), xt)
    disp = disp[:, :E * C].reshape(B, E, C, D)

    h = torch.einsum("becd,edf->becf", disp, p["wi"])
    g = F.silu(torch.einsum("becd,edf->becf", disp, p["wg"]))
    y_e = torch.einsum("becf,efd->becd", h * g, p["wo"])        # [B, E, C, D]

    # ---- combine: each (token, choice) reads its slot (the zero row when
    # dropped) ----
    y_flat = torch.cat([y_e.reshape(B, E * C, D),
                        y_e.new_zeros((B, 1, D))], 1)
    picked = torch.gather(y_flat, 1, slot[..., None].expand(B, S * k, D))
    picked = picked.reshape(B, S, k, D)
    if m.combine == "scatter":
        # the reference weights each slot in y's dtype and adds the k slots
        # of a token into it; the sum over k here runs in a fixed order, so
        # a decode repeats bit for bit on the card
        y = (picked * topv.to(y_e.dtype)[..., None]).sum(2)
    else:
        y = torch.einsum("bskd,bsk->bsd", picked, topv.to(x.dtype))

    if m.num_shared:
        y = y + mlp_apply(p["shared"], x, act="silu")
    return y, aux.float()
