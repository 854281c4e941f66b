"""Mixture-of-experts FFN: top-k routing, capacity-based dispatch
(counterpart of ``repro.models.moe``), and a dropless layer of the port's
own (`_moe_apply_dropless`, ``cfg.moe.dropless``).

Each row (batch element) has its own expert queues: a token's k choices,
taken in row-major (token, choice) order, get queue positions from a
cumulative count; a choice at position >= capacity is dropped (its
residual path still carries the token).  The expert GEMMs process E*C
slots per row.  Router aux (load-balance) loss follows Switch/GShard:
E * sum_e f_e * P_e.

On a mesh (an active ``ShardingCtx`` with a ``DeviceMesh`` and both a
data and a model axis) the layer runs as the reference's expert-parallel
island, its ``shard_map`` over the mesh's process groups: each rank routes
its block of tokens (split over the data axes, replicated over the model
axis) to its block of experts, and the partial outputs meet in an
all-reduce over the model axis.  The data-dependent dispatch scatter is
always local to a rank.

The dropless layer computes every (token, choice) whose expert it holds:
the held choices sorted by expert, three grouped products over the
experts' row ranges (``torch._grouped_mm`` with offsets made on the
device), and the results gathered back and summed over the k choices in
a fixed order.  Nothing is read on the host, so its buffers are sized for
the most held choices there can be (every one of the T * k); only the
first ``n`` rows, the held ones, are computed, and the rest are masked on
the way in and out.  ``cfg.moe.experts_held`` makes a layer that holds
that many of the experts (this card's share of an expert-parallel
group): the router scores all of them, the layer computes its own
experts' part of the result, and nothing stands in for the rest.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import NULL_CTX, Draw, ShardingCtx, dense_init
from repro_torch.models.mlp import mlp_apply, mlp_params


def moe_params(draw: Draw, cfg: ArchConfig):
    """The router over all experts, the ``cfg.moe.n_held`` experts this
    card holds, and the shared experts."""
    m = cfg.moe
    D, E, Fe, Eh = cfg.d_model, m.num_experts, m.d_expert, m.n_held
    p = {
        "wr": dense_init(draw, D, E, dtype=torch.float32),
        "wi": draw.normal((Eh, D, Fe), D ** -0.5),
        "wg": draw.normal((Eh, D, Fe), D ** -0.5),
        "wo": draw.normal((Eh, Fe, D), Fe ** -0.5),
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


def moe_apply(p, x, *, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar).  On a mesh, the
    expert-parallel island (`_moe_apply_island`); else the dropless layer
    when ``cfg.moe.dropless``, or the reference's ``_moe_apply_local``,
    with both of its combines."""
    if ctx.active and ctx.mesh is not None and ctx.batch and ctx.model:
        return _moe_apply_island(p, x, cfg=cfg, ctx=ctx)
    if cfg.moe.dropless:
        return _moe_apply_dropless(p, x, cfg=cfg, model_index=0, ctx=ctx)
    return _moe_apply_local(p, x, cfg=cfg, ctx=ctx)


def _moe_apply_local(p, x, *, cfg: ArchConfig, ctx: ShardingCtx):
    """The reference's ``_moe_apply_local``: `_moe_apply_manual` over all
    E experts (rank 0 of a model axis of one), with ``ctx``'s layout hints
    and the config's combine."""
    return _moe_apply_manual(p, x, cfg=cfg, model_index=0, ctx=ctx,
                             combine=cfg.moe.combine)


# ------------------------------------------------ the expert-parallel island

def _island_specs(p, model_axis: str) -> dict:
    """The island's weight specs (the reference's ``wspec``): the router
    replicated, the experts split over the model axis, the shared experts
    tensor-parallel (``wi``/``wg`` by columns, ``wo`` by rows)."""
    from repro_torch.dist.sharding import P

    mx = model_axis
    spec = {"wr": P(), "wi": P(mx, None, None), "wg": P(mx, None, None),
            "wo": P(mx, None, None)}
    if "shared" in p:
        spec["shared"] = {k: P(None, mx) if k != "wo" else P(mx, None)
                          for k in p["shared"]}
    return spec


def _axis_index(mesh, axes) -> tuple:
    """(this rank's index over ``axes`` of ``mesh``, the first major, and
    their size)."""
    names = tuple(mesh.mesh_dim_names)
    index, count = 0, 1
    for a in axes:
        d = names.index(a)
        index = index * mesh.size(d) + mesh.get_local_rank(d)
        count *= mesh.size(d)
    return index, count


def _local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole, as
    ``shard_map`` hands it out: each dim the spec names split evenly over
    its axes."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        index, count = _axis_index(mesh, axes)
        if t.shape[d] % count:
            raise ValueError(f"dim {d} of size {t.shape[d]} does not split "
                             f"over mesh axes {axes} of size {count}")
        n = t.shape[d] // count
        t = t.narrow(d, index * n, n)
    return t


_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _group(mesh, axes):
    """The process group over ``axes`` of ``mesh``, made once a mesh (a
    group over several axes is made collectively)."""
    from repro_torch.core.sync import mesh_axis_group

    groups = _GROUPS.setdefault(mesh, {})
    if axes not in groups:
        groups[axes] = mesh_axis_group(mesh, axes)
    return groups[axes]


class _PSum(torch.autograd.Function):
    """All-reduce (sum) over ``group``; its transpose is the same sum of
    the cotangents, as the reference's ``psum`` is in a ``shard_map``."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        # gloo may refuse a 16-bit CUDA all-reduce: such a payload is summed
        # in float32 and rounded once, which for two ranks is the exact sum
        # correctly rounded
        wide = (out.dtype in (torch.bfloat16, torch.float16)
                and dist.get_backend(group) == "gloo")
        buf = out.float() if wide else out
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype) if wide else buf

    @staticmethod
    def backward(ctx, grad):
        return _PSum.apply(grad, ctx.group), None


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    return x if dist.get_world_size(group) == 1 else _PSum.apply(x, group)


def _moe_apply_island(p, x, *, cfg: ArchConfig, ctx: ShardingCtx):
    """The reference's ``shard_map`` island over ``ctx.mesh``: tokens split
    over the data axes ``ctx.batch``, experts over ``ctx.model``; each
    rank runs `_moe_apply_manual` on its blocks, its partial output is
    summed over the model axis's group and aux averaged over the data
    axes' group.

    ``x`` and the leaves of ``p`` may be DTensors on the mesh (each is
    redistributed to the island's layout and its local block taken; y
    comes back a DTensor split over the data axes, aux replicated), or
    tensors every rank holds whole (each rank takes its block, and y is
    gathered whole over the data axes' group, so every rank returns what
    the local path returns)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import P, _zip_map, placements

    mesh, dp, mx = ctx.mesh, tuple(ctx.batch), ctx.model
    x_spec = P(dp, None, None)

    def local(spec, t):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements(spec, mesh)).to_local()
        return _local_block(t, spec, mesh)

    model_index, _ = _axis_index(mesh, (mx,))
    dp_group, dp_size = _group(mesh, dp), _axis_index(mesh, dp)[1]
    y, aux = _moe_apply_manual(_zip_map(local, _island_specs(p, mx), p),
                               local(x_spec, x), cfg=cfg,
                               model_index=model_index)
    y = _psum(y, _group(mesh, (mx,)))            # combine across experts
    aux = _psum(aux, dp_group) / dp_size
    if isinstance(x, DTensor):
        return (DTensor.from_local(y, mesh, placements(x_spec, mesh),
                                   run_check=False, shape=x.shape,
                                   stride=x.stride()),
                DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False))
    if dp_size > 1:
        parts = [torch.empty_like(y) for _ in range(dp_size)]
        dist.all_gather(parts, y.contiguous(), group=dp_group)
        y = torch.cat(parts, 0)
    return y, aux


def _moe_apply_manual(p, x, *, cfg: ArchConfig, model_index: int,
                      ctx: ShardingCtx = NULL_CTX, combine: str = "gather"):
    """Manual EP on one rank's blocks: tokens replicated over the model
    axis; this rank (``model_index`` along it) dispatches to ITS E_loc
    experts and returns a partial [B, S, D] (the caller sums it over the
    model axis).  Global slots run from ``lo = model_index * E_loc * C``;
    the slots outside this rank's range drop to the pad row.  With all E
    experts and rank 0 this is the local layer, which also passes its
    ``ctx`` (layout hints, the shared MLP's) and ``combine``; the island
    always gathers."""
    B, S, D = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    C = capacity(S, cfg)
    E_loc = p["wi"].shape[0]
    lo = model_index * E_loc * C

    with obs.region("lm.moe.route"):
        # float32 logits whatever the router's dtype (AdamW hands every
        # leaf back in bf16), as the reference's promotion gives them
        logits = x.float() @ p["wr"].float()
        gates = torch.softmax(logits, -1)                       # [B, S, E]
        topv, topi = top_k(gates, k)                            # [B, S, k]
        if m.norm_topk_prob:
            topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

        # ---- aux load-balance loss (Switch form) ----
        me = gates.mean((0, 1))                                 # P_e
        ce = F.one_hot(topi[..., 0], E).float().mean((0, 1))    # f_e (top-1)
        aux = E * (me * ce).sum()

        # ---- per-row positions in each expert queue ----
        choice_e = topi.reshape(B, S * k)                       # row-major
        onehot = F.one_hot(choice_e, E)                         # [B, S*k, E]
        pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)
        slot = torch.where(pos < C, choice_e * C + pos, E * C)  # global slots
        mine = (slot >= lo) & (slot < lo + E_loc * C)
        rec = obs.active()
        if rec is not None:
            e0 = model_index * E_loc
            held = onehot[..., e0:e0 + E_loc]                   # [B, S*k, El]
            rec.tally(moe_rows=mine.sum(),
                      dropped=held.sum() - mine.sum())
            rec.peak(moe_rows_max=(held * (pos < C)[..., None]).sum(
                (0, 1)).max())
        slot = torch.where(mine, slot - lo, E_loc * C)          # mine or drop

    with obs.region("lm.moe.experts"):
        # ---- dispatch: kept slots are unique within a row, so a scatter
        # of the token copies is the reference's scatter-add; the dropped
        # ones all land on the pad row E_loc*C, which is sliced away ----
        xt = x.repeat_interleave(k, dim=1)                      # [B, S*k, D]
        idx = slot[..., None].expand(B, S * k, D)
        disp = x.new_zeros((B, E_loc * C + 1, D))
        disp.scatter_(1, idx, xt)
        disp = disp[:, :E_loc * C].reshape(B, E_loc, C, D)
        disp = ctx.ct(disp, ctx.batch, ctx.model, None, None)   # EP layout

        h = torch.einsum("becd,edf->becf", disp, p["wi"])
        g = F.silu(torch.einsum("becd,edf->becf", disp, p["wg"]))
        y_e = torch.einsum("becf,efd->becd", h * g, p["wo"])    # [B,E,C,D]
        y_e = ctx.ct(y_e, ctx.batch, None, None, None)      # combine layout

    with obs.region("lm.moe.combine"):
        # ---- combine: each (token, choice) reads its slot (the zero row
        # when dropped) ----
        y_flat = torch.cat([y_e.reshape(B, E_loc * C, D),
                            y_e.new_zeros((B, 1, D))], 1)
        picked = torch.gather(y_flat, 1, idx).reshape(B, S, k, D)
        if combine == "scatter":
            # the reference weights each slot in y's dtype and adds the k
            # slots of a token into it; the sum over k here runs in a fixed
            # order, so a decode repeats bit for bit on the card
            y = (picked * topv.to(y_e.dtype)[..., None]).sum(2)
        else:
            y = torch.einsum("bskd,bsk->bsd", picked, topv.to(x.dtype))

    if m.num_shared:
        y = y + mlp_apply(p["shared"], x, act="silu", ctx=ctx)
    return y, aux.float()


def _grouped(a: torch.Tensor, w: torch.Tensor,
             ends: torch.Tensor) -> torch.Tensor:
    """Rows ``[ends[e-1], ends[e])`` of ``a`` [M, K] times ``w[e]`` [K, N],
    for each expert e, in one grouped product; the rows past ``ends[-1]``
    are left as they fall (the caller masks them)."""
    if a.is_cuda and a.dtype != torch.bfloat16:
        raise ValueError(f"the dropless layer's grouped products take "
                         f"bfloat16 on the card, got {a.dtype}")
    return torch._grouped_mm(a, w, offs=ends)


def _moe_apply_dropless(p, x, *, cfg: ArchConfig, model_index: int,
                        ctx: ShardingCtx = NULL_CTX):
    """The dropless layer over this card's E_loc experts (``model_index``
    along an expert-parallel group: experts ``[model_index * E_loc,
    (model_index + 1) * E_loc)``): every (token, choice) routed to one of
    them is computed, and the partial [B, S, D] it returns holds their
    part of the result plus the shared experts'.  Returns (y, aux) as
    `_moe_apply_manual` does; nothing is read on the host."""
    B, S, D = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    E_loc = p["wi"].shape[0]
    T = B * S
    dev = x.device
    lo = model_index * E_loc

    with obs.region("lm.moe.route"):
        gates = torch.softmax(x.float() @ p["wr"].float(), -1)  # [B, S, E]
        topv, topi = top_k(gates, k)                            # [B, S, k]
        if m.norm_topk_prob:
            topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        # aux load-balance loss (Switch form), as the capacity layer's
        me = gates.mean((0, 1))
        ce = (topi[..., :1] == torch.arange(E, device=dev)).float().mean(
            (0, 1))
        aux = E * (me * ce).sum()

        # the choices in token-major order, the held ones first, sorted by
        # expert (stable: a token's rows stay in token order); ``ends[e]``
        # is where expert e's rows end
        e = topi.reshape(T * k) - lo
        held = (e >= 0) & (e < E_loc)
        key = torch.where(held, e, E_loc)
        order = torch.argsort(key, stable=True)
        ends = torch.searchsorted(
            key[order], torch.arange(1, E_loc + 1, device=dev)).to(
                torch.int32)
        live = (torch.arange(T * k, device=dev) < ends[-1])[:, None]
        rec = obs.active()
        if rec is not None:
            rows = torch.diff(ends, prepend=ends.new_zeros(1))
            rec.tally(moe_rows=ends[-1].long())
            rec.peak(moe_rows_max=rows.max().long())

    with obs.region("lm.moe.experts"):
        # token t's copies are rows t*k .. t*k+k-1 (an expand: its backward
        # sums them in a fixed order), then permuted; the rows past the
        # held ones are zeroed on the way in, so whatever the products
        # leave in them, no gradient flows back through them
        xs = x.reshape(T, 1, D).expand(T, k, D).reshape(T * k, D)[order]
        xs = torch.where(live, xs, 0)
        h = _grouped(xs, p["wi"], ends)
        g = F.silu(_grouped(xs, p["wg"], ends))
        ys = torch.where(live, _grouped(h * g, p["wo"], ends), 0)
        if rec is not None:
            # a held choice whose expert output came back all zero was
            # not computed
            rec.tally(dropped=(live & (ys == 0).all(-1, keepdim=True)).sum())

    with obs.region("lm.moe.combine"):
        # back to (token, choice) order by the inverse permutation (each
        # row written once), weighted, and summed over k in a fixed order
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(T * k, device=dev))
        y = (ys[inv].reshape(B, S, k, D)
             * topv.to(ys.dtype)[..., None]).sum(2)

    if m.num_shared:
        y = y + mlp_apply(p["shared"], x, act="silu", ctx=ctx)
    return y, aux.float()
