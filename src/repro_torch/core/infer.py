"""Fixed-phi fold-in: the inference body that serving runs (counterpart of
``repro.core.infer``).

Messages live token-major as [T, K] (``TokenLayout``).  Each sweep is one
call of the carry sweep ``kernels.power_sweep.ops.power_sweep_carry`` in
serving mode: on a CUDA tensor the hand-written kernel, on a CPU tensor
its plain version.  The sweep reads the normalized phi rows by index, so
the [T, K] gather of phi that the reference's jnp path builds is never
made, and phi is never copied: frozen and empty tokens carry the guard id
``W'`` (phi's own row count) instead of reading an appended zero row.

A document freezes once the geometric tail of its residual,
r * rho / (1 - rho) with rho the sweep-over-sweep decay clipped to
[0.8, 0.95], drops below ``residual_tol`` per token.

Random message inits come from the caller's ``torch.Generator``; the JAX
package draws them from ``jax.random``, which torch cannot reproduce, so
``fold_in_tokens`` takes an injected ``mu0`` and the slab step an injected
``init_u`` for tests that hold the two packages against each other.

A topic-sharded phi (``topic_shards = N > 1``) is served as the reference
serves it: the shards stacked [N, W, K/N] on a leading axis
(`split_topic_shards`), every tensor of the body carrying that axis, and
the renormalization and residual sums psum'd over it (``StackedReducer``,
byte-metered).  The random init is drawn at the global K and sliced per
shard, so sharded and unsharded fold-ins start from the same field.  As
in the reference (whose Pallas path needs ``topic_shards == 1``), this
path runs torch code, not the serving kernel, on whatever device holds
phi.

Over the ``model`` axis of a mesh (``model_group`` of M ranks), each rank
stacks its own N/M shards, the topic columns from its ``topic_offset``,
and the psums also all-reduce over the group (``RankStackedReducer``).
Every rank draws the init at the global K from the same seed and keeps
its own columns, and theta leaves the step as the rank's [D, K/M] block.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.sync import (CommMeter, LocalReducer,
                                   RankStackedReducer, StackedReducer)
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.kernels.power_sweep.ops import power_sweep_carry


@dataclasses.dataclass
class FoldInResult:
    """theta [D, K] normalized topic mixture; iters — sweeps run (early exit
    included); mean_r — final mean residual per token; r_doc [D] — final
    per-document residual."""

    theta: torch.Tensor
    iters: int
    mean_r: torch.Tensor
    r_doc: torch.Tensor


def _init_field(generator: Optional[torch.Generator], batch: MiniBatch,
                cfg: LDAConfig, device: torch.device) -> torch.Tensor:
    """The random field U(0.01, 1), drawn at [D, max(init_pad_len, L), K]
    and sliced to L, so a document's init does not depend on the bucket
    that admitted it."""
    D, L = batch.word_ids.shape
    Lpad = L if cfg.init_pad_len is None else max(cfg.init_pad_len, L)
    u = torch.rand((D, Lpad, cfg.num_topics), generator=generator,
                   device=device)[:, :L]
    return u * (1.0 - 0.01) + 0.01


def _init_messages(generator: Optional[torch.Generator], batch: MiniBatch,
                   cfg: LDAConfig, device: torch.device) -> torch.Tensor:
    """`_init_field` normalized over K."""
    u = _init_field(generator, batch, cfg, device)
    return u / u.sum(dim=-1, keepdim=True)


def _shard_columns(x: torch.Tensor, n: int, offset: int = 0,
                   width: Optional[int] = None) -> torch.Tensor:
    """[..., K] -> [n, ..., width]: the columns of ``n`` topic shards of
    ``width`` (K/n when not given) from column ``offset``, stacked."""
    width = x.shape[-1] // n if width is None else int(width)
    x = x[..., offset:offset + n * width]
    return x.reshape(*x.shape[:-1], n, width).movedim(-2, 0)


def _merge_columns(x: torch.Tensor) -> torch.Tensor:
    """[N, ..., K/N] -> [..., K], the inverse of `_shard_columns`."""
    return x.movedim(0, -2).reshape(*x.shape[1:-1], -1)


def _sharded_sweep(act_tok, doc_l, c, mu, theta, phi_tok, cfg: LDAConfig,
                   reducer: StackedReducer, num_docs: int, norm_phase: str,
                   rw_phase: str):
    """One fold-in sweep over topic shards stacked on the leading axis, the
    reference's jnp body: mu [N, T, Kl], theta [N, D, Kl], phi_tok [N, T,
    Kl] (phi at each token's row), c [T, 1], act_tok [T] bool.  The
    normalizer and the per-document residual are psum'd over the shards.
    Returns new (mu, theta, r_doc [D])."""
    N, T, Kl = mu.shape
    unnorm = theta[:, doc_l] - c * mu + cfg.alpha
    unnorm.mul_(phi_tok)
    norm = reducer.psum(unnorm.sum(dim=-1, keepdim=True), norm_phase,
                        compress=False)
    mu_new = torch.where(act_tok[:, None], unnorm / norm.clamp_min(1e-30),
                         mu)
    delta = c * (mu_new - mu)
    theta = theta + delta.reshape(N, num_docs, -1, Kl).sum(dim=2)
    r_local = delta.abs_().reshape(N, num_docs, -1).sum(dim=-1)
    return mu_new, theta, reducer.psum(r_local, rw_phase,
                                       compress=False)[0]


def _tail_active(r_doc, r_prev, tok_d, tol: float) -> torch.Tensor:
    rho = torch.clamp(r_doc / r_prev.clamp_min(1e-30), 0.8, 0.95)
    tail = r_doc * rho / (1.0 - rho)
    return tail > tol * tok_d


@functools.lru_cache(maxsize=None)
def _zero_phi_tot(K: int, device: torch.device) -> torch.Tensor:
    """The serving sweep's phi_tot: zeros, read-only, one per (K, device)."""
    return torch.zeros(K, dtype=torch.float32, device=device)


def _serve_sweep(p_tok, doc_ids, c, mu, theta, phi, cfg: LDAConfig):
    """One serving sweep: mu updated in place, returns (theta_delta, r)."""
    _, th_delta, r_local = power_sweep_carry(
        p_tok, doc_ids, c, mu, theta, _zero_phi_tot(phi.shape[1], phi.device),
        phi, alpha=cfg.alpha, beta=0.0, wbeta=1.0, n_guard=phi.shape[0])
    return th_delta, r_local


def fold_in_tokens(batch: MiniBatch, phi_norm_wk: torch.Tensor,
                   cfg: LDAConfig, iters: int = 30,
                   residual_tol: float = 0.0,
                   model_reducer: Optional[LocalReducer] = None, *,
                   generator: Optional[torch.Generator] = None,
                   mu0: Optional[torch.Tensor] = None,
                   device="cuda") -> FoldInResult:
    """Token-major BP fold-in with phi fixed.

    ``phi_norm_wk`` [W', K] is the normalized topic-word matrix.
    ``residual_tol == 0`` runs every document all ``iters`` sweeps; a
    positive tolerance freezes each document once its residual tail
    clears it and stops when all have.  ``mu0`` [D, L, K] replaces the
    random init drawn from ``generator``.  The loop reads one flag back
    from the device per sweep (whether any document is still active).
    """
    dev = resolve_device(device)
    reducer = model_reducer or LocalReducer()
    phi = phi_norm_wk.to(dev, torch.float32).contiguous()
    layout = MiniBatch(batch.word_ids.to(dev, torch.int32),
                       batch.counts.to(dev, torch.float32)).token_layout()
    D, L = layout.num_docs, layout.max_len
    K = phi.shape[1]
    T = layout.num_slots
    c = layout.counts.contiguous()
    tok_d = c.reshape(D, L).sum(dim=1)
    total = tok_d.sum().clamp_min(1.0)
    if mu0 is None:
        mu0 = _init_messages(generator, batch, cfg, dev)
    mu = mu0.to(dev, torch.float32).reshape(T, K).clone()
    theta = layout.to_batch_major(c * mu).sum(dim=1)
    doc_ids = layout.doc_ids
    doc_l = doc_ids.long()
    wid_t = layout.word_ids
    guard = torch.full_like(wid_t, phi.shape[0])
    r_doc = torch.full((D,), float("inf"), device=dev)
    r_prev = torch.ones((D,), device=dev)
    t = 0
    while t < iters:
        act = _tail_active(r_doc, r_prev, tok_d, residual_tol)
        if not bool(act.any()):
            break
        p_tok = torch.where(act[doc_l], wid_t, guard)
        th_delta, r_local = _serve_sweep(p_tok, doc_ids, c, mu, theta, phi,
                                         cfg)
        theta = theta + th_delta
        r_prev, r_doc = r_doc, reducer.psum(r_local, "model_rw_loop",
                                            compress=False)
        t += 1
    th = theta + cfg.alpha
    denom = reducer.psum(th.sum(dim=-1, keepdim=True), "theta_norm",
                         compress=False)
    return FoldInResult(theta=th / denom, iters=t,
                        mean_r=r_doc.sum() / total, r_doc=r_doc)


def fold_in_tokens_sharded(batch: MiniBatch, phi_shards: torch.Tensor,
                           cfg: LDAConfig, iters: int = 30,
                           residual_tol: float = 0.0,
                           model_reducer: Optional[StackedReducer] = None, *,
                           generator: Optional[torch.Generator] = None,
                           mu0: Optional[torch.Tensor] = None,
                           topic_offset: int = 0,
                           device="cuda") -> FoldInResult:
    """`fold_in_tokens` over a topic-sharded phi: ``phi_shards`` [n, W',
    K/N] (`split_topic_shards`), the body in torch code with the shard
    axis leading every tensor and the model psums through
    ``model_reducer`` (a ``StackedReducer`` over n when not given; over a
    mesh, a ``RankStackedReducer`` holding this rank's n = N/M shards).
    The init field (drawn at the global K, or ``mu0`` [D, L, K]) is cut to
    the shards' columns from ``topic_offset``, split by topic shard and
    normalized by the psum'd sum, as the reference's ``_init_messages``
    does.  theta comes back merged, [D, n K/N]: [D, K] in one process,
    this rank's block over a mesh."""
    dev = resolve_device(device)
    phi = phi_shards.to(dev, torch.float32)
    N = phi.shape[0]
    reducer = model_reducer or StackedReducer(N)
    layout = MiniBatch(batch.word_ids.to(dev, torch.int32),
                       batch.counts.to(dev, torch.float32)).token_layout()
    D, T = layout.num_docs, layout.num_slots
    c = layout.counts
    tok_d = c.reshape(D, -1).sum(dim=1)
    total = tok_d.sum().clamp_min(1.0)
    doc_l = layout.doc_ids.long()
    with reducer.meter.section():
        u = (_init_field(generator, batch, cfg, dev) if mu0 is None
             else mu0.to(dev, torch.float32))
        u = _shard_columns(u, N, topic_offset, phi.shape[-1]
                           ).reshape(N, T, -1)
        mu = u / reducer.psum(u.sum(dim=-1, keepdim=True), "model_norm",
                              compress=False)
        del u
        phi_tok = phi[:, layout.word_ids.long()]                # [N, T, Kl]
        theta = (c * mu).reshape(N, D, -1, mu.shape[-1]).sum(dim=2)
        r_doc = torch.full((D,), float("inf"), device=dev)
        r_prev = torch.ones((D,), device=dev)
        t = 0
        while t < iters:
            act = _tail_active(r_doc, r_prev, tok_d, residual_tol)
            if not bool(act.any()):
                break
            with reducer.meter.section():
                mu, theta, r_new = _sharded_sweep(
                    act[doc_l], doc_l, c, mu, theta, phi_tok, cfg, reducer,
                    D, "model_norm_loop", "model_rw_loop")
            r_prev, r_doc = r_doc, r_new
            t += 1
        th = theta + cfg.alpha
        th = th / reducer.psum(th.sum(dim=-1, keepdim=True), "theta_norm",
                               compress=False)
    return FoldInResult(theta=_merge_columns(th), iters=t,
                        mean_r=r_doc.sum() / total, r_doc=r_doc)


def make_fold_in_step(cfg: LDAConfig, fold_iters: int = 30,
                      residual_tol: float = 0.0, topic_shards: int = 1,
                      sync_dtype=torch.float32, device="cuda",
                      model_group=None) -> Tuple[object, CommMeter]:
    """The bucket engine's serving step.  Returns (step, meter) with
    ``step(phi_norm, word_ids, counts, *, generator=None, mu0=None) ->
    (theta [D, K], iters, mean_r)``; phi is an argument so one copy on the
    device serves every bucket shape.  With ``topic_shards > 1`` phi is
    the [N, W, K/N] stack of `split_topic_shards` and the step runs
    `fold_in_tokens_sharded`, its model psums metered per request
    batch.  With ``model_group`` (the process group of a mesh's ``model``
    axis, M ranks) phi is this rank's [N/M, W, K/N] stack, the psums
    all-reduce over the group, and theta is this rank's [D, K/M] block."""
    dev = resolve_device(device)
    meter = CommMeter()
    ranks, rank = _group_position(model_group)
    if topic_shards == 1 and ranks == 1:
        reducer = LocalReducer(meter=meter, sync_dtype=sync_dtype)
        fold = fold_in_tokens
        offset = {}
    else:
        reducer = _sharded_reducer(cfg.num_topics, topic_shards, ranks,
                                   model_group, meter, sync_dtype)
        fold = fold_in_tokens_sharded
        offset = {"topic_offset": rank * cfg.num_topics // ranks}

    def step(phi_norm, word_ids, counts, *, generator=None, mu0=None):
        res = fold(MiniBatch(word_ids, counts), phi_norm, cfg,
                   iters=fold_iters, residual_tol=residual_tol,
                   model_reducer=reducer, generator=generator, mu0=mu0,
                   device=dev, **offset)
        return res.theta, res.iters, res.mean_r

    return step, meter


def _check_divides(K: int, topic_shards: int, ranks: int = 1) -> None:
    if topic_shards % ranks:
        raise ValueError(f"topic_shards={topic_shards} does not split over "
                         f"the {ranks} ranks of the model axis")
    if topic_shards < 1 or K % topic_shards:
        raise ValueError(f"num_topics={K} does not divide over "
                         f"{topic_shards} topic shards")


def _group_position(group) -> Tuple[int, int]:
    """(ranks, this rank's index) of a model-axis process group; (1, 0)
    for none."""
    if group is None:
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def _sharded_reducer(K: int, topic_shards: int, ranks: int, group,
                     meter: CommMeter, sync_dtype):
    """The model reducer of N topic shards, this rank's N/M of them over a
    group of M ranks (a ``StackedReducer`` when M = 1)."""
    _check_divides(K, topic_shards, ranks)
    if ranks == 1:
        return StackedReducer(topic_shards, meter=meter,
                              sync_dtype=sync_dtype)
    return RankStackedReducer(topic_shards // ranks, group, meter=meter,
                              sync_dtype=sync_dtype)


# --------------------------------------------------------------------------
# continuous-batching slab step
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SlabState:
    """The in-flight fold-in slab: a fixed [B, L] grid of request slots,
    updated in place step over step.

    word_rows int32 [B, L] · counts f32 [B, L] · mu f32 [B*L, K] ·
    theta f32 [B, K] · r_doc f32 [B] · r_prev f32 [B] · it int32 [B] ·
    live bool [B]
    """

    word_rows: torch.Tensor
    counts: torch.Tensor
    mu: torch.Tensor
    theta: torch.Tensor
    r_doc: torch.Tensor
    r_prev: torch.Tensor
    it: torch.Tensor
    live: torch.Tensor


def _to_device(x, dtype, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to a card through pinned memory without
    waiting for the card (a pageable copy would wait for queued work)."""
    t = torch.as_tensor(np.asarray(x)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def make_slab_step(cfg: LDAConfig, *, slots: int, slot_len: int,
                   refill_cap: Optional[int] = None,
                   sweeps_per_step: int = 2, fold_iters: int = 30,
                   residual_tol: float = 1e-2, topic_shards: int = 1,
                   sync_dtype=torch.float32, device="cuda",
                   model_group=None):
    """Continuous-batching serving step: refill free slots, advance every
    slot ``sweeps_per_step`` fold-in sweeps, retire the converged.

    Returns ``(init_state, step, meter)``::

        init_state() -> SlabState (all slots empty)
        step(phi_norm, state, refill_rows [R, L], refill_cnt [R, L],
             refill_slot [R], warm_theta [R, K], warm_mask [R], *,
             generator=None, init_u=None)
          -> (state, retired [B] bool, theta_out [B, K], iters [B] int32,
              r_doc [B])

    The refill buffers are host arrays (``data.batching.slab_refill``);
    lanes whose slot index is ``slots`` are unused.  A refilled slot's
    messages start from ``init_u`` [R, L, K] (uniform in [0.01, 1), drawn
    from ``generator`` when not given), or, when ``warm_mask`` is set, from
    ``warm_theta * phi`` (a warm start from a cached theta).  ``state`` is
    updated in place and returned.  The step never waits for the device.

    With ``topic_shards = N > 1``, phi is the [N, W, K/N] stack of
    `split_topic_shards`, the state's mu and theta carry the shard axis
    ([N, B*L, K/N], [N, B, K/N]), and the sweeps run `_sharded_sweep`
    with the model psums metered: the refill's init normalizer over all R
    lanes in one section (as the reference's step computes it), the
    sweeps' and theta's in the step's.  With ``model_group`` (a mesh's
    ``model`` axis, M ranks) phi and the state hold this rank's N/M
    shards, the topic columns from rank x K/M: ``init_u`` and
    ``warm_theta`` stay [.., K] (every rank draws the same field and keeps
    its columns), the psums all-reduce over the group, and ``theta_out``
    is this rank's [B, K/M] block.
    """
    B, L = int(slots), int(slot_len)
    R = B if refill_cap is None else int(refill_cap)
    if not 0 < R <= B:
        raise ValueError(f"refill_cap={R} outside [1, slots={B}]")
    if sweeps_per_step < 1:
        raise ValueError(f"sweeps_per_step must be >= 1: {sweeps_per_step}")
    dev = resolve_device(device)
    K = cfg.num_topics
    N = int(topic_shards)
    meter = CommMeter()
    ranks, rank = _group_position(model_group)
    sharded = N > 1 or ranks > 1
    if sharded:
        reducer = _sharded_reducer(K, N, ranks, model_group, meter,
                                   sync_dtype)
    else:
        _check_divides(K, N)
        reducer = LocalReducer(meter=meter, sync_dtype=sync_dtype)
    n = N // ranks                                    # this rank's shards
    Kn = K // N
    offset = rank * (K // ranks)
    lead = (n,) if sharded else ()
    doc_ids = torch.arange(B, dtype=torch.int32, device=dev
                           ).repeat_interleave(L)
    doc_l = doc_ids.long()
    tol = float(residual_tol)

    def init_state() -> SlabState:
        return SlabState(
            word_rows=torch.zeros((B, L), dtype=torch.int32, device=dev),
            counts=torch.zeros((B, L), dtype=torch.float32, device=dev),
            mu=torch.zeros(lead + (B * L, Kn), dtype=torch.float32,
                           device=dev),
            theta=torch.zeros(lead + (B, Kn), dtype=torch.float32,
                              device=dev),
            r_doc=torch.zeros((B,), dtype=torch.float32, device=dev),
            r_prev=torch.ones((B,), dtype=torch.float32, device=dev),
            it=torch.zeros((B,), dtype=torch.int32, device=dev),
            live=torch.zeros((B,), dtype=torch.bool, device=dev))

    def active_slots(st: SlabState, tok_d) -> torch.Tensor:
        return (st.live & (st.it < fold_iters)
                & _tail_active(st.r_doc, st.r_prev, tok_d, tol))

    def sharded_init(phi_norm, init_u, refill_rows, refill_cnt, warm_theta,
                     warm_mask, lane_d):
        """The init of every refill lane over this rank's topic shards
        (the normalizer psum'd over all of them), then this step's lanes:
        (mu0 [n, lanes, L, Kn], theta0 [n, lanes, Kn])."""
        with meter.section():
            rows = _to_device(refill_rows, torch.long, dev)
            warm = _shard_columns(_to_device(warm_theta, torch.float32,
                                             dev), n, offset, Kn)
            wmask = _to_device(warm_mask, torch.bool, dev)
            u = torch.where(wmask[:, None, None],
                            warm[:, :, None, :] * phi_norm[:, rows],
                            _shard_columns(init_u.to(dev, torch.float32), n,
                                           offset, Kn))
            norm0 = reducer.psum(u.sum(dim=-1, keepdim=True),
                                 "slab_init_norm", compress=False)
            mu0 = (u / norm0.clamp_min(1e-30)).index_select(1, lane_d)
        cnt = _to_device(refill_cnt, torch.float32, dev).index_select(
            0, lane_d)
        return mu0, (cnt[..., None] * mu0).sum(dim=2)

    def refill(phi_norm, st, refill_rows, refill_cnt, refill_slot,
               warm_theta, warm_mask, generator, init_u):
        lanes = np.nonzero(np.asarray(refill_slot) < B)[0]
        if lanes.size == 0:
            return
        if init_u is None:
            init_u = torch.rand((R, L, K), generator=generator,
                                device=dev) * (1.0 - 0.01) + 0.01
        lane_d = _to_device(lanes, torch.long, dev)
        slot_d = _to_device(np.asarray(refill_slot)[lanes], torch.long, dev)
        rows = _to_device(np.asarray(refill_rows)[lanes], torch.int32, dev)
        cnt = _to_device(np.asarray(refill_cnt)[lanes], torch.float32, dev)
        if sharded:
            mu0, theta0 = sharded_init(phi_norm, init_u, refill_rows,
                                       refill_cnt, warm_theta, warm_mask,
                                       lane_d)
            st.mu.view(n, B, L, -1).index_copy_(1, slot_d, mu0)
            st.theta.index_copy_(1, slot_d, theta0)
        else:
            warm = _to_device(np.asarray(warm_theta)[lanes], torch.float32,
                              dev)
            wmask = _to_device(np.asarray(warm_mask)[lanes], torch.bool, dev)
            u = init_u.to(dev, torch.float32).index_select(0, lane_d)
            warm_u = warm[:, None, :] * phi_norm[rows.long()]    # [n, L, K]
            u = torch.where(wmask[:, None, None], warm_u, u)
            norm0 = reducer.psum(u.sum(dim=-1, keepdim=True),
                                 "slab_init_norm", compress=False)
            mu0 = u / norm0.clamp_min(1e-30)
            st.mu.view(B, L, K).index_copy_(0, slot_d, mu0)
            st.theta.index_copy_(0, slot_d, (cnt[..., None] * mu0).sum(dim=1))
        st.word_rows.index_copy_(0, slot_d, rows)
        st.counts.index_copy_(0, slot_d, cnt)
        st.live.index_fill_(0, slot_d, True)
        st.r_doc.index_fill_(0, slot_d, float("inf"))
        st.r_prev.index_fill_(0, slot_d, 1.0)
        st.it.index_fill_(0, slot_d, 0)

    def step(phi_norm, state: SlabState, refill_rows, refill_cnt,
             refill_slot, warm_theta, warm_mask, *, generator=None,
             init_u=None):
        with meter.section():
            refill(phi_norm, state, refill_rows, refill_cnt, refill_slot,
                   warm_theta, warm_mask, generator, init_u)
            c = state.counts.view(B * L, 1)
            tok_d = state.counts.sum(dim=1)
            wid_t = state.word_rows.view(B * L)
            if sharded:
                phi_tok = phi_norm[:, wid_t.long()]           # [n, T, Kn]
            else:
                guard = torch.full_like(wid_t, phi_norm.shape[0])
            for _ in range(sweeps_per_step):
                act_d = active_slots(state, tok_d)
                if sharded:
                    state.mu, state.theta, r_new = _sharded_sweep(
                        act_d[doc_l], doc_l, c, state.mu, state.theta,
                        phi_tok, cfg, reducer, B, "slab_norm_loop",
                        "slab_rw_loop")
                else:
                    p_tok = torch.where(act_d[doc_l], wid_t, guard)
                    th_delta, r_local = _serve_sweep(
                        p_tok, doc_ids, c, state.mu, state.theta, phi_norm,
                        cfg)
                    state.theta += th_delta
                    r_new = reducer.psum(r_local, "slab_rw_loop",
                                         compress=False)
                state.r_prev = torch.where(act_d, state.r_doc, state.r_prev)
                state.r_doc = torch.where(act_d, r_new, state.r_doc)
                state.it = state.it + act_d.to(torch.int32)
            still = active_slots(state, tok_d)
            retired = state.live & ~still
            th_out = state.theta + cfg.alpha
            th_out = th_out / reducer.psum(th_out.sum(dim=-1, keepdim=True),
                                           "slab_theta_norm", compress=False)
        state.live = still
        return (state, retired, _merge_columns(th_out) if sharded else th_out,
                state.it.clone(), state.r_doc.clone())

    return init_state, step, meter


def split_topic_shards(phi_norm_wk: torch.Tensor, topic_shards: int,
                       ranks: int = 1) -> torch.Tensor:
    """[W, K] -> [N, W, K/N] contiguous topic shards (the layout the steps
    take with ``topic_shards = N``); N = 1 returns phi as it is.  Over a
    mesh's model axis of ``ranks`` = M > 1, ``phi_norm_wk`` is this rank's
    [W, K/M] block and the result its [N/M, W, K/N] stack."""
    if topic_shards == 1 and ranks == 1:
        return phi_norm_wk
    _check_divides(phi_norm_wk.shape[1] * ranks, topic_shards, ranks)
    return _shard_columns(phi_norm_wk, topic_shards // ranks).contiguous()


def fold_in_dense_reference(batch: MiniBatch, phi_norm_wk: torch.Tensor,
                            cfg: LDAConfig, iters: int = 30, *,
                            generator: Optional[torch.Generator] = None,
                            mu0: Optional[torch.Tensor] = None,
                            device="cuda") -> torch.Tensor:
    """Oracle: the dense [D, L, K] fold-in scan (fixed sweep count, no
    early exit, whole-tensor rewrite per sweep)."""
    dev = resolve_device(device)
    phi = phi_norm_wk.to(dev, torch.float32)
    counts = batch.counts.to(dev, torch.float32)
    mu = (_init_messages(generator, batch, cfg, dev) if mu0 is None
          else mu0.to(dev, torch.float32))
    mu = mu / mu.sum(dim=-1, keepdim=True)
    phi_tok = phi[batch.word_ids.to(dev).long()]                 # [D, L, K]
    c = counts[..., None]
    for _ in range(iters):
        theta = torch.einsum("dl,dlk->dk", counts, mu)
        unnorm = (theta[:, None, :] - c * mu + cfg.alpha) * phi_tok
        mu = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    theta = torch.einsum("dl,dlk->dk", counts, mu) + cfg.alpha
    return theta / theta.sum(dim=-1, keepdim=True)
