"""PowerSync: the paper's communication-efficient sync generalized to
data-parallel gradient all-reduce (counterpart of
``repro.optim.powersync``).

Mapping from the paper's LDA quantities:

  phi_hat sync (Eq. 4)        ->  gradient all-reduce
  residual matrix r (Eq. 7-9) ->  error-feedback accumulator (unsent gradient
                                  mass kept locally, re-eligible later: Fig.
                                  3's dynamic re-selection)
  power words (rows)          ->  top round(lambda_r * rows) rows by synced
                                  row norm of |acc|
  power topics (cols)         ->  top round(lambda_c * cols) cols by synced
                                  col norm of the picked rows

As in the reference, the selection is rectangular (rows x cols) from two
cheap norm vectors, and both norm vectors are psum'd, so every shard picks
identical indices.  The pack ``a2[sel_r][:, sel_c]`` and the two scatters
(the synced mean into zeros, and ``-packed`` into the residual, which
leaves exactly +0.0 where the reference sets 0.0) run through the port's
power-pack kernels (``kernels/power_pack/ops.py``): on a CUDA tensor they
launch the hand-written kernels, on a CPU tensor their plain versions.
Each (row, col) pair is selected once, so the scatter's atomics land in a
fixed result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.sync import Reducer
from repro_torch.kernels.power_pack import ops as pack_ops
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class PowerSyncConfig:
    lambda_rows: float = 0.2       # fraction of rows synced per step
    lambda_cols: float = 0.5       # fraction of cols synced per step
    min_dense_size: int = 4096     # tensors this small or smaller sync densely
    sync_every_dense: int = 0      # 0=never: periodic full sync (robustness)


def _as_2d(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """View any >=2-D tensor as [rows, cols] (leading dims merged)."""
    shape = tuple(x.shape)
    return x.reshape(-1, shape[-1]), shape


@torch.no_grad()
def powersync_tree(grads: Any, residual: Any, reducer: Reducer,
                   cfg: PowerSyncConfig, num_shards: int):
    """Compressed all-reduce with error feedback.

    Returns (synced_mean_grads, new_residual).  Over repeated steps every
    coordinate's accumulated mass is eventually transmitted (residual
    re-selection).  The leaves are synced in the reference's flatten order
    (sorted dict keys, list order), so the shards' psums meet in order.
    """

    def one(g, r):
        acc = g.float() + r
        if acc.dim() < 2 or acc.numel() <= cfg.min_dense_size:
            synced = reducer.psum(acc, "powersync_dense")
            return (synced / num_shards).to(g.dtype), torch.zeros_like(acc)

        a2, shape = _as_2d(acc)
        rows, cols = a2.shape
        P = max(1, int(round(cfg.lambda_rows * rows)))
        Pc = max(1, int(round(cfg.lambda_cols * cols)))

        # step 1: power rows from the synchronized row-norm vector
        row_norm = reducer.psum(a2.abs().sum(1), "powersync_norms",
                                compress=False)
        sel_r = torch.topk(row_norm, P).indices
        # step 2: power cols from the synchronized col-norm of picked rows
        col_norm = reducer.psum(a2[sel_r].abs().sum(0), "powersync_norms",
                                compress=False)
        sel_c = torch.topk(col_norm, Pc).indices
        sel_w = sel_r.to(torch.int32)
        sel_k = sel_c.to(torch.int32)[None].expand(P, Pc).contiguous()
        packed = pack_ops.pack_rows(a2, sel_w, sel_k)             # [P, Pc]

        # the only payload-sized collective: the packed power submatrix
        packed_sum = reducer.psum(packed, "powersync_payload")

        synced = pack_ops.scatter_add_rows(torch.zeros_like(a2), sel_w,
                                           sel_k, packed_sum / num_shards)
        # error feedback: what this shard did not transmit stays local;
        # acc is this call's own tensor, so it becomes the residual in place
        new_res = pack_ops.scatter_add_rows(a2, sel_w, sel_k, -packed)
        return synced.reshape(shape).to(g.dtype), new_res.reshape(shape)

    out = [one(g, r) for (_, g), (_, r) in
           zip(tree_leaves(grads), tree_leaves(residual))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def residual_init(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def dense_sync_tree(grads: Any, reducer: Reducer, num_shards: int):
    """The baseline (Eq. 4 analogue): full-gradient all-reduce."""
    return tree_unflatten(grads, [
        (reducer.psum(g.float(), "dense_grads") / num_shards).to(g.dtype)
        for _, g in tree_leaves(grads)])
