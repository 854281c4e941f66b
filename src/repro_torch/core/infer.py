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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.sync import (CommMeter, LocalReducer,
                                   topic_shards_unsupported)
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


def _init_messages(generator: Optional[torch.Generator], batch: MiniBatch,
                   cfg: LDAConfig, device: torch.device) -> torch.Tensor:
    """Random init drawn at [D, max(init_pad_len, L), K] and sliced to L, so
    a document's init does not depend on the bucket that admitted it."""
    D, L = batch.word_ids.shape
    Lpad = L if cfg.init_pad_len is None else max(cfg.init_pad_len, L)
    u = torch.rand((D, Lpad, cfg.num_topics), generator=generator,
                   device=device)[:, :L]
    u = u * (1.0 - 0.01) + 0.01
    return u / u.sum(dim=-1, keepdim=True)


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


def make_fold_in_step(cfg: LDAConfig, fold_iters: int = 30,
                      residual_tol: float = 0.0, topic_shards: int = 1,
                      sync_dtype=torch.float32, device="cuda"
                      ) -> Tuple[object, CommMeter]:
    """The bucket engine's serving step.  Returns (step, meter) with
    ``step(phi_norm, word_ids, counts, *, generator=None, mu0=None) ->
    (theta [D, K], iters, mean_r)``; phi is an argument so one copy on the
    device serves every bucket shape."""
    topic_shards_unsupported(topic_shards)
    dev = resolve_device(device)
    meter = CommMeter()
    reducer = LocalReducer(meter=meter, sync_dtype=sync_dtype)

    def step(phi_norm, word_ids, counts, *, generator=None, mu0=None):
        res = fold_in_tokens(MiniBatch(word_ids, counts), phi_norm, cfg,
                             iters=fold_iters, residual_tol=residual_tol,
                             model_reducer=reducer, generator=generator,
                             mu0=mu0, device=dev)
        return res.theta, res.iters, res.mean_r

    return step, meter


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
                   sync_dtype=torch.float32, device="cuda"):
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
    """
    B, L = int(slots), int(slot_len)
    R = B if refill_cap is None else int(refill_cap)
    if not 0 < R <= B:
        raise ValueError(f"refill_cap={R} outside [1, slots={B}]")
    if sweeps_per_step < 1:
        raise ValueError(f"sweeps_per_step must be >= 1: {sweeps_per_step}")
    topic_shards_unsupported(topic_shards)
    dev = resolve_device(device)
    K = cfg.num_topics
    meter = CommMeter()
    reducer = LocalReducer(meter=meter, sync_dtype=sync_dtype)
    doc_ids = torch.arange(B, dtype=torch.int32, device=dev
                           ).repeat_interleave(L)
    doc_l = doc_ids.long()
    tol = float(residual_tol)

    def init_state() -> SlabState:
        return SlabState(
            word_rows=torch.zeros((B, L), dtype=torch.int32, device=dev),
            counts=torch.zeros((B, L), dtype=torch.float32, device=dev),
            mu=torch.zeros((B * L, K), dtype=torch.float32, device=dev),
            theta=torch.zeros((B, K), dtype=torch.float32, device=dev),
            r_doc=torch.zeros((B,), dtype=torch.float32, device=dev),
            r_prev=torch.ones((B,), dtype=torch.float32, device=dev),
            it=torch.zeros((B,), dtype=torch.int32, device=dev),
            live=torch.zeros((B,), dtype=torch.bool, device=dev))

    def active_slots(st: SlabState, tok_d) -> torch.Tensor:
        return (st.live & (st.it < fold_iters)
                & _tail_active(st.r_doc, st.r_prev, tok_d, tol))

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
        warm = _to_device(np.asarray(warm_theta)[lanes], torch.float32, dev)
        wmask = _to_device(np.asarray(warm_mask)[lanes], torch.bool, dev)
        u = init_u.to(dev, torch.float32).index_select(0, lane_d)
        warm_u = warm[:, None, :] * phi_norm[rows.long()]        # [n, L, K]
        u = torch.where(wmask[:, None, None], warm_u, u)
        norm0 = reducer.psum(u.sum(dim=-1, keepdim=True), "slab_init_norm",
                             compress=False)
        mu0 = u / norm0.clamp_min(1e-30)
        theta0 = (cnt[..., None] * mu0).sum(dim=1)
        st.word_rows.index_copy_(0, slot_d, rows)
        st.counts.index_copy_(0, slot_d, cnt)
        st.live.index_fill_(0, slot_d, True)
        st.mu.view(B, L, K).index_copy_(0, slot_d, mu0)
        st.theta.index_copy_(0, slot_d, theta0)
        st.r_doc.index_fill_(0, slot_d, float("inf"))
        st.r_prev.index_fill_(0, slot_d, 1.0)
        st.it.index_fill_(0, slot_d, 0)

    def step(phi_norm, state: SlabState, refill_rows, refill_cnt,
             refill_slot, warm_theta, warm_mask, *, generator=None,
             init_u=None):
        refill(phi_norm, state, refill_rows, refill_cnt, refill_slot,
               warm_theta, warm_mask, generator, init_u)
        c = state.counts.view(B * L, 1)
        tok_d = state.counts.sum(dim=1)
        wid_t = state.word_rows.view(B * L)
        guard = torch.full_like(wid_t, phi_norm.shape[0])
        for _ in range(sweeps_per_step):
            act_d = active_slots(state, tok_d)
            p_tok = torch.where(act_d[doc_l], wid_t, guard)
            th_delta, r_local = _serve_sweep(p_tok, doc_ids, c, state.mu,
                                             state.theta, phi_norm, cfg)
            state.theta += th_delta
            r_new = reducer.psum(r_local, "slab_rw_loop", compress=False)
            state.r_prev = torch.where(act_d, state.r_doc, state.r_prev)
            state.r_doc = torch.where(act_d, r_new, state.r_doc)
            state.it = state.it + act_d.to(torch.int32)
        still = active_slots(state, tok_d)
        retired = state.live & ~still
        th_out = state.theta + cfg.alpha
        denom = reducer.psum(th_out.sum(dim=-1, keepdim=True),
                             "slab_theta_norm", compress=False)
        state.live = still
        return (state, retired, th_out / denom, state.it.clone(),
                state.r_doc.clone())

    return init_state, step, meter


def split_topic_shards(phi_norm_wk: torch.Tensor, topic_shards: int
                       ) -> torch.Tensor:
    """[W, K] -> the layout the steps consume; only N = 1 is ported."""
    topic_shards_unsupported(topic_shards)
    return phi_norm_wk


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
