"""POBP training on one device: the paper's Fig. 4 mini-batch, the
counterpart of ``repro.core.pobp`` for one shard.

One mini-batch (`pobp_minibatch`): a random message init; the dense t=1
sweep and the dense Eq. 4 sync; then, in ``power`` sync mode, a loop of
power-word and power-topic selection (``core/power.py``), the selective
sweep, the packed Eq. 6 sync and the packed-carry refresh, until the mean
residual falls below ``cfg.residual_tol`` or ``cfg.inner_iters`` is
reached; last, the Eq. 11 fold into ``phi_acc``.  ``dense`` sync mode
repeats the dense sweep instead (the classic baseline).

Kernels, chosen by the device of the tensors (a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain version):

  - the dense sweep: ``kernels/bp_update`` (``bp_update``);
  - the selective sweep, by ``cfg.sweep_policy`` (``core/sweep_dispatch``):
    the training mode of ``kernels/power_sweep``
    (``power_sweep_carry_train``), which reads the selection and phi
    directly, or, for ``packed``, the phi pack of ``kernels/power_pack``
    (``pack_rows``, through ``core.power``) and the packed sweep
    ``kernels/power_sweep/packed`` (``power_sweep_tokens``);
  - the phi fold of each selective iteration: ``kernels/power_pack``
    (``scatter_add_rows``, through ``core.power``);
  - the fixed-order sums that the reference leaves to XLA's scatter-adds:
    the word scatter of the phi delta and residuals
    (``kernels/segment_sum::word_rows_sum``, through
    ``core.residuals.token_scatter_wk``) and the phi_tot refresh
    (``kernels/segment_sum::topic_sum``).

Every sum on the card runs in a fixed order, or adds with atomics only
values whose order cannot matter (one writer an element, or exact zeros),
so a step run twice from one state repeats bit for bit, and a crash-resume
reproduces the uninterrupted run.

A capacity-laddered run (``live_w``, the dynamic vocabulary) holds phi_acc
at a rung W_cap > live_w: rows in [live_w, W_cap) are guard rows that no
token has.  The smoothing mass is ``live_w * beta`` (float32), never
``W_cap * beta``, and the power selection masks the guard rows and keeps
``floor(lambda_w * live_w)`` power words (``core.power.
select_power_words_live``), its remaining slots all on the first guard
row; so the trajectory depends on the live vocabulary, not on the rung.

``cfg.phi_acc_dtype = "bfloat16"`` keeps phi_acc at half width: the
accumulate runs in float32, every phi and residual statistic sync ships at
bf16, and the step folds the result back by stochastic rounding
(``core/quantize``), its dither drawn from a generator derived from the
run's seed and the batch number, never from the run's own stream.

The reference's ``lax.while_loop`` is a Python loop here: each iteration
reads the mean residual back to the host once to decide whether to go on.
While a torch profiler records, `make_train_step`'s step is recorded in
``repro_torch.obs``: its root ``pobp.step``; ``pobp.iter`` around each
iteration after the dense one, with ``pobp.select``, ``pobp.sweep`` and
``pobp.refresh`` inside it in ``power`` sync mode; ``pobp.read`` around
each host read; and the step's counters (``iters``, ``selective_iters``,
the counted ``tokens``, ``P``, ``Pk``, ``K`` and the ``power_tokens`` that
its selective sweeps reached).
The port updates in place where that saves a [W, K] or [T, K] copy, and
says so per function.

One per-shard body (`pobp_shard_body`) serves every execution mode, as in
the reference, through the two reducers it is handed (``core/sync``): a
data reducer over the shards that split the documents and a model reducer
over the shards that split the topics.  ``LocalReducer`` for both is the
single device (OBP); `make_train_step` and `make_sim_minibatch_fn` with
``num_shards > 1`` run N data shards in lockstep on one device
(``SimReducer``, the reference's vmap); `make_mesh_shard_fn` and
`shard_map_minibatch_fn` run one shard a process of a ``DeviceMesh``
(``MeshReducer``, the reference's shard_map).  With more than one topic
shard the dense sweep cannot normalize inside ``bp_update`` (the kernel
sums over all of K): it runs the reference's formulation in torch code
on whatever device holds the tensors (unnormalized messages, the
normalizer psum'd over topic shards, the divide), as the reference runs
jnp code and no Pallas kernel there.  That is not a plain version standing
in for a kernel: ``bp_update`` never falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import power as pw
from repro_torch.core import quantize
from repro_torch.core.device import resolve_device
from repro_torch.core.residuals import (mean_residual, packed_rw_delta,
                                        token_scatter_wk)
from repro_torch.core.sweep_dispatch import resolve_sweep_policy
from repro_torch.core.sync import (CommMeter, LocalReducer, MeshReducer,
                                   PSReducer, Reducer, SimReducer, lockstep,
                                   mesh_axis_group)
from repro_torch.core.types import (LDAConfig, LDATrainState, MiniBatch,
                                    TokenLayout)
from repro_torch.kernels.bp_update.ops import bp_update
from repro_torch.kernels.power_sweep.ops import power_sweep_carry_train
from repro_torch.kernels.power_sweep.packed import power_sweep_tokens
from repro_torch.kernels.segment_sum.ops import topic_sum

SYNC_MODES = ("power", "dense")


def _smoothing(cfg: LDAConfig, wbeta) -> float:
    """The W*beta smoothing mass: ``wbeta`` when given (a live-W run's
    live_w * beta), else ``cfg.vocab_size * cfg.beta``."""
    return cfg.vocab_size * cfg.beta if wbeta is None else wbeta


def _theta(counts: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Eq. (2): theta[d, k] = sum_l c[d, l] mu[d, l, k], contiguous."""
    return torch.einsum("dl,dlk->dk", counts, mu).contiguous()


# --------------------------------------------------------------------------
# dense (full) sweep: Fig. 4 lines 3-8 and the `dense` sync mode
# --------------------------------------------------------------------------

def dense_sweep(batch: MiniBatch, mu: torch.Tensor, phi_eff_wk: torch.Tensor,
                phi_tot: torch.Tensor, cfg: LDAConfig,
                layout: Optional[TokenLayout] = None,
                model_reducer: Optional[Reducer] = None,
                norm_phase: str = "model_norm", wbeta=None):
    """One synchronous full update of all messages (Eq. 1).

    mu [D, L, Kl]; phi_eff_wk [W, Kl] is the effective statistic
    (accumulated prior plus this mini-batch's contribution) over this
    shard's Kl topics; phi_tot [Kl] its column sums.  With one topic shard
    the normalization over K runs inside ``bp_update`` (the reference's
    ``dense_sweep_pallas`` branch); with ``model_reducer`` spanning more,
    `_dense_sweep_sharded` psums it under ``norm_phase``.  ``wbeta``
    overrides the W*beta smoothing mass (a live-W run passes live_w *
    beta).  Returns new tensors (mu_new [D, L, Kl], r_wk [W, Kl]).
    """
    layout = layout or batch.token_layout()
    wbeta = _smoothing(cfg, wbeta)
    if model_reducer is not None and model_reducer.shards > 1:
        return _dense_sweep_sharded(batch, mu, phi_eff_wk, phi_tot, cfg,
                                    layout, model_reducer, norm_phase, wbeta)
    D, L, K = mu.shape
    mu_new, r_tok = bp_update(
        layout.word_ids, layout.doc_ids, layout.counts,
        mu.reshape(D * L, K).contiguous(),
        _theta(batch.counts, mu), phi_eff_wk, phi_tot, alpha=cfg.alpha,
        beta=cfg.beta, wbeta=wbeta)
    return (mu_new.reshape(D, L, K),
            token_scatter_wk(layout.word_ids, r_tok, cfg.vocab_size,
                             layout.word_runs(cfg.vocab_size)))


def _dense_sweep_sharded(batch: MiniBatch, mu, phi_eff_wk, phi_tot,
                         cfg: LDAConfig, layout: TokenLayout,
                         model_reducer: Reducer, norm_phase: str,
                         wbeta: float):
    """The dense sweep over one topic shard, the reference's jnp
    ``dense_sweep``: the unnormalized messages over this shard's topics,
    their per-token sum psum'd over the topic shards, then the divide.
    Torch code on the tensors' device; the reference runs no kernel here
    either."""
    W = cfg.vocab_size
    c = batch.counts[..., None]
    self_c = c * mu
    unnorm = _theta(batch.counts, mu)[:, None, :] - self_c + cfg.alpha
    unnorm.mul_(phi_eff_wk[batch.word_ids.long()] - self_c + cfg.beta)
    unnorm.div_(phi_tot - self_c + wbeta)
    del self_c
    norm = model_reducer.psum(torch.sum(unnorm, dim=-1, keepdim=True),
                              norm_phase, compress=False)
    mu_new = unnorm.div_(norm)
    return mu_new, token_scatter_wk(batch.word_ids, c * (mu_new - mu).abs(),
                                    W, layout.word_runs(W))


# --------------------------------------------------------------------------
# selective sweep, the seed-layout oracle: Fig. 4 lines 15-21
# --------------------------------------------------------------------------

def selective_sweep(batch: MiniBatch, mu, theta, phi_eff_wk, phi_tot,
                    sel_w, sel_k, cfg: LDAConfig):
    """Update messages only at (power word, power topic) coordinates.

    SEED-LAYOUT ORACLE, in plain PyTorch ops: it works on the [D, L, K]
    batch-major messages and returns a new tensor for each output.  The
    training loop runs the token-major `selective_sweep_tokens` below, the
    same sweep within float associativity; this version stays as its
    semantics oracle.  sel_w [P] power word ids; sel_k [P, Pk] power topic
    ids a power word.  Token deltas scatter straight into the packed
    [P, Pk] sync buffers.

    Returns (mu_new, theta_new, delta_phi_packed, r_packed).
    """
    D, L = batch.word_ids.shape
    P, Pk = sel_k.shape
    K = mu.shape[-1]
    p_tok = pw.word_to_row(sel_w, cfg.vocab_size)[batch.word_ids.long()]
    is_power = p_tok >= 0                                        # [D, L]
    p_safe = torch.where(is_power, p_tok, 0).long()
    k_tok = sel_k.long()[p_safe]                                 # [D, L, Pk]

    c = batch.counts[..., None]                                  # [D, L, 1]
    mu_sel = torch.gather(mu, -1, k_tok)                         # [D, L, Pk]
    sel_mass = mu_sel.sum(-1, keepdim=True)                      # conserved
    self_c = c * mu_sel
    theta_sel = torch.gather(theta[:, None, :].expand(D, L, K), -1, k_tok)
    phi_pack = phi_eff_wk[sel_w.long()[:, None], sel_k.long()]  # [P, Pk]
    phi_sel = phi_pack[p_safe]                                   # [D, L, Pk]
    pt_sel = phi_tot[k_tok]                                      # [D, L, Pk]

    th = theta_sel - self_c + cfg.alpha
    ph = phi_sel - self_c + cfg.beta
    pt = pt_sel - self_c + cfg.vocab_size * cfg.beta
    u = th * ph / pt
    # renormalize within the selected coordinates, conserving their old mass
    # (unselected message entries stay put, so sum_k mu == 1 is invariant)
    mu_new_sel = u * sel_mass / u.sum(-1, keepdim=True).clamp_min(1e-30)
    mu_new_sel = torch.where(is_power[..., None], mu_new_sel, mu_sel)

    d_mu = mu_new_sel - mu_sel                                   # [D, L, Pk]
    mu_new = mu.scatter(-1, k_tok, mu_new_sel)

    # theta update: scatter c * d_mu into [D, K] at the selected coordinates
    d_idx = torch.arange(D, device=mu.device)[:, None, None].expand(D, L, Pk)
    theta_new = theta.index_put((d_idx, k_tok), c * d_mu, accumulate=True)

    # packed sync buffers: scatter straight to [P, Pk] (row P drops padding)
    p_drop = torch.where(is_power, p_tok, P).reshape(-1).long()  # [D*L]
    dv = (c * d_mu).reshape(-1, Pk)
    rv = (c * d_mu.abs()).reshape(-1, Pk)
    zeros = torch.zeros((P + 1, Pk), dtype=mu.dtype, device=mu.device)
    delta_phi_packed = zeros.clone().index_add_(0, p_drop, dv)[:P]
    r_packed = zeros.index_add_(0, p_drop, rv)[:P]
    return mu_new, theta_new, delta_phi_packed, r_packed


# --------------------------------------------------------------------------
# token-major selective sweep: Fig. 4 lines 15-21
# --------------------------------------------------------------------------

def selective_sweep_tokens(layout: TokenLayout, mu_t, theta, phi_eff_wk,
                           phi_tot, sel_w, sel_k, cfg: LDAConfig,
                           policy: Optional[str] = None, wbeta=None):
    """One selective sweep at the (power word, power topic) coordinates,
    in the formulation ``policy`` names (default: ``cfg.sweep_policy``
    resolved by ``resolve_sweep_policy``), as the reference's
    ``selective_sweep_tokens_pallas`` dispatches: ``packed`` runs
    `_selective_sweep_packed`, every other policy `_selective_sweep_carry`.
    The two compute the same sweep within float associativity.

    mu_t [T, K] token-major messages, updated IN PLACE; theta [D, K] the
    doc-topic statistic of mu_t; phi_eff_wk [W, K]; phi_tot [K]; sel_w
    [P]; sel_k [P, Pk]; ``wbeta`` the smoothing mass (default W*beta).
    Returns (mu_t, theta_new, d_pack [P, Pk], r_pack [P, Pk]).
    """
    policy = policy or resolve_sweep_policy(cfg)
    fn = (_selective_sweep_packed if policy == "packed"
          else _selective_sweep_carry)
    return fn(layout, mu_t, theta, phi_eff_wk, phi_tot, sel_w, sel_k, cfg,
              wbeta)


def _selective_sweep_carry(layout: TokenLayout, mu_t, theta, phi_eff_wk,
                           phi_tot, sel_w, sel_k, cfg: LDAConfig,
                           wbeta=None):
    """The carry formulation, the reference's
    ``_selective_sweep_carry_pallas``: the training mode of the carry sweep
    (``power_sweep_carry_train``), which reads ``sel_w``, ``sel_k`` and phi
    directly where the reference builds [P+1, K] phi and mask row tables
    and reads its [P, K] delta/residual rows back at ``sel_k``; its d/r
    sums add each power word's tokens in the layout's word runs, a run
    longer than ``kernels.token_order.FOLD_CHUNK`` in the layout's
    chunks."""
    W = cfg.vocab_size
    p_tok = pw.token_power_rows(layout.word_ids, sel_w, W)
    mu_t, theta_delta, d_pack, r_pack = power_sweep_carry_train(
        p_tok, layout.doc_ids, layout.counts, mu_t, theta, phi_tot,
        phi_eff_wk, sel_w, sel_k, alpha=cfg.alpha, beta=cfg.beta,
        wbeta=_smoothing(cfg, wbeta), runs=layout.word_runs(W),
        chunks=layout.word_chunks(W))
    return mu_t, theta + theta_delta, d_pack, r_pack


def _selective_sweep_packed(layout: TokenLayout, mu_t, theta, phi_eff_wk,
                            phi_tot, sel_w, sel_k, cfg: LDAConfig,
                            wbeta=None):
    """The packed-stream formulation, the reference's packed path
    (``selective_sweep_tokens_pallas`` with policy ``packed``): the [P, Pk]
    phi pack (``pack_rows``), then ``power_sweep_tokens``, which gathers,
    updates and stores back at the selected coordinates only.  Its plain
    version sums the packed buffers as the reference's jnp
    ``_selective_sweep_packed`` does: a one-hot contraction while
    T * P <= ``cfg.onehot_crossover``, a row ``index_add_`` past it."""
    P = sel_k.shape[0]
    p_tok = pw.token_power_rows(layout.word_ids, sel_w, cfg.vocab_size)
    phi_pack = pw.pack_rows(phi_eff_wk, sel_w, sel_k)
    mu_t, theta_delta, d_pack, r_pack = power_sweep_tokens(
        p_tok, layout.doc_ids, layout.counts, mu_t, theta, phi_tot, phi_pack,
        sel_k, alpha=cfg.alpha, beta=cfg.beta,
        wbeta=_smoothing(cfg, wbeta),
        onehot=layout.num_slots * P <= cfg.onehot_crossover,
        order=layout.sweep_order)
    return mu_t, theta + theta_delta, d_pack, r_pack


# --------------------------------------------------------------------------
# one mini-batch (Fig. 4 body, one m)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MinibatchResult:
    phi_acc_new: torch.Tensor      # [W, K] accumulated statistic after this batch
    iters: int                     # iterations run (the dense one included)
    mean_r: torch.Tensor           # final mean residual (line 26), 0-d
    mu: torch.Tensor               # final messages [D, L, K]
    theta: torch.Tensor            # final doc-topic statistics [D, K]


def _uniform_init(shape, generator, device) -> torch.Tensor:
    """The random message field U(0.01, 1) at ``shape``."""
    u = torch.rand(shape, generator=generator, device=device)
    return u * (1.0 - 0.01) + 0.01


def _init_shape(batch: MiniBatch, K: int, cfg: LDAConfig):
    """[D, Lpad, K]: ``Lpad`` honours ``cfg.init_pad_len`` as the reference
    does, so the init of a document does not depend on the L bucket its
    batch landed in."""
    D, L = batch.word_ids.shape
    return (D, L if cfg.init_pad_len is None else max(cfg.init_pad_len, L),
            K)


def _draw_u0(batch: MiniBatch, K: int, cfg: LDAConfig, generator,
             u0: Optional[torch.Tensor], device) -> torch.Tensor:
    """The random message field at [D, Lpad, K] (`_init_shape`), sliced to
    L.  ``u0`` [D, Lpad, K] replaces the draw from ``generator`` (tests
    inject the reference's ``jax.random.uniform`` draw)."""
    shape = _init_shape(batch, K, cfg)
    if u0 is None:
        u0 = _uniform_init(shape, generator, device)
    elif tuple(u0.shape) != shape:
        raise ValueError(f"u0 must have shape {shape}, got "
                         f"{tuple(u0.shape)}")
    return u0.to(device=device, dtype=torch.float32)[:, :batch.max_len]


def pobp_minibatch(batch: MiniBatch, phi_acc_wk: torch.Tensor, total_tokens,
                   delta_weight: float, cfg: LDAConfig,
                   data_reducer: Optional[Reducer] = None,
                   model_reducer: Optional[Reducer] = None,
                   sync_mode: str = "power", live_w=None,
                   decay: Optional[float] = None, *,
                   generator: Optional[torch.Generator] = None,
                   u0: Optional[torch.Tensor] = None) -> MinibatchResult:
    """Run one mini-batch to convergence on this shard (all Fig. 4 lines).

    ``batch`` holds this shard's [Dl, L] documents on phi_acc's device;
    ``phi_acc_wk`` [W, Kl] float32 or bfloat16 is the synchronized
    accumulated statistic over this shard's topics (left unchanged; the
    result is float32, the caller narrows it); ``total_tokens`` the
    mini-batch's global token count; ``delta_weight`` the Eq. 11 weight on
    this batch's delta; ``decay`` (or None) the Robbins-Monro retention on
    the historical statistic.  Every psum goes through ``data_reducer``
    (the document shards) or ``model_reducer`` (the topic shards) under the
    reference's phase, the once-a-batch part in one meter section and each
    inner iteration in one of its own.  The random init comes from
    ``generator``, or from an injected ``u0`` [Dl, Lpad, Kl].
    ``phi_acc_new`` reuses the storage of the step's working statistic
    ``phi_eff``; nothing the caller passed is modified.

    ``live_w`` (an int, or None for a fixed vocabulary) makes the W axis a
    capacity rung: ``cfg.vocab_size`` = W_cap > live_w, every word id of
    the batch below live_w, rows [live_w, W_cap) guard rows.  The smoothing
    mass is float32(live_w) * beta and the power selection
    `core.power.select_power_words_live`'s; the guard rows stay exactly 0.
    """
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"unknown sync_mode: {sync_mode}")
    reducer = data_reducer or LocalReducer()
    model = model_reducer or LocalReducer(meter=reducer.meter)
    dev = phi_acc_wk.device
    W = cfg.vocab_size
    K = phi_acc_wk.shape[1]
    P, Pk = cfg.num_power_words, min(cfg.num_power_topics, K)
    _check_ported(cfg)
    wbeta = None if live_w is None else _live_wbeta(cfg, live_w)
    policy = resolve_sweep_policy(cfg)
    layout = batch.token_layout()
    runs = layout.word_runs(W)
    c3 = batch.counts[..., None]
    # compressed-accumulator runs ship every phi/residual statistic sync at
    # the storage width, as the reference's phi_wire does
    phi_wire = (torch.bfloat16 if cfg.phi_acc_dtype == "bfloat16"
                else None)
    rec = obs.active()
    if rec is not None:
        # the counted tokens of each word, from its run: a selective
        # sweep's power tokens are those of its power words
        per_word = runs[1].diff()
        power_tokens = torch.zeros((), dtype=torch.int64, device=dev)

    with reducer.meter.section():
        # ---- lines 3-8: random init, local stats, first dense update ----
        u = _draw_u0(batch, K, cfg, generator, u0, dev)
        mu0 = u / model.psum(torch.sum(u, -1, keepdim=True), "model_norm",
                             compress=False)
        del u
        phi_eff = phi_acc_wk + token_scatter_wk(batch.word_ids, c3 * mu0, W,
                                                runs)
        phi_tot = _topic_totals(phi_eff, live_w)
        mu1, r_wk_local = dense_sweep(batch, mu0, phi_eff, phi_tot, cfg,
                                      layout, model, wbeta=wbeta)
        del mu0, phi_eff

        # ---- lines 9-10: dense synchronization of phi and r ----
        phi_eff = phi_acc_wk + reducer.psum(
            token_scatter_wk(batch.word_ids, c3 * mu1, W, runs), "dense",
            w_rows=W, dtype=phi_wire)
        phi_tot = _topic_totals(phi_eff, live_w)
        r_glob = reducer.psum(r_wk_local, "dense", w_rows=W, dtype=phi_wire)
        del r_wk_local
        theta = _theta(batch.counts, mu1)
        r_w = model.psum(torch.sum(r_glob, dim=1), "model_rw",
                         compress=False, w_rows=W)

        def go_on(t: int, r_w: torch.Tensor) -> bool:
            # the one host read per iteration; r_w is psum'd, so every
            # shard reads the same bits and takes the same decision
            if t >= cfg.inner_iters:
                return False
            with obs.span(rec, "pobp.read"):
                r = float(mean_residual(r_w, total_tokens))
            return r > cfg.residual_tol

        t = 1
        if sync_mode == "power":
            mu_t = mu1.reshape(layout.num_slots, K)
            while go_on(t, r_w):
                with obs.span(rec, "pobp.iter"), reducer.meter.section():
                    with obs.span(rec, "pobp.select"):
                        # a live-W selection's dead slots repeat the first
                        # guard row, whose residual and phi rows are zero
                        sel_w = (pw.select_power_words(r_w, P)
                                 if live_w is None
                                 else pw.select_power_words_live(
                                     r_w, P, live_w, cfg.lambda_w))
                        sel_k = pw.select_power_topics(r_glob, sel_w, Pk)
                    with obs.span(rec, "pobp.sweep"):
                        mu_t, theta, d_pack, r_pack = selective_sweep_tokens(
                            layout, mu_t, theta, phi_eff, phi_tot, sel_w,
                            sel_k, cfg, policy, wbeta)
                    if rec is not None:
                        # counted while the card runs the sweep
                        power_tokens.add_(per_word.index_select(0, sel_w)
                                          .sum())
                    with obs.span(rec, "pobp.refresh"):
                        # lines 23-24: sync only the power submatrices
                        d_pack = reducer.psum(d_pack, "power", w_rows=W,
                                              dtype=phi_wire)
                        r_pack = reducer.psum(r_pack, "power", w_rows=W,
                                              dtype=phi_wire)
                        # packed-carry refresh, Eq. 9: O(P*Pk) updates, in
                        # place.  Each row's topics are distinct and the
                        # power words are too, but for a live-W selection's
                        # dead slots, which all repeat the first guard row
                        # and carry exact zeros (no token has that word).
                        # The phi scatter and the r_w index_add add with
                        # atomics on the card, so the repeated row takes a
                        # sum of zeros in any order: the same bits; the
                        # residual refresh writes the same zeros from each
                        # dead slot.  Every other element has one writer,
                        # so their order does not matter; phi_tot's
                        # per-topic sums do, and topic_sum takes them in a
                        # fixed order.  Each shard updates its own phi_eff
                        # and r_glob (psum results are never shared between
                        # shards)
                        rw_delta = packed_rw_delta(r_glob, sel_w, sel_k,
                                                   r_pack)
                        pw.scatter_add_rows(phi_eff, sel_w, sel_k, d_pack)
                        phi_tot = topic_sum(sel_k, d_pack, phi_tot)
                        pw.scatter_set_rows(r_glob, sel_w, sel_k, r_pack)
                        # the topic shards' share of each power word's
                        # residual: a model psum (the data shards' is
                        # already in r_pack)
                        rw_delta = model.psum(rw_delta, "model_rw_loop",
                                              compress=False, w_rows=W)
                        r_w = r_w.index_add(0, sel_w.long(), rw_delta)
                t += 1
            mu = layout.to_batch_major(mu_t)
        else:
            mu = mu1
            while go_on(t, r_w):
                with obs.span(rec, "pobp.iter"), reducer.meter.section():
                    mu, r_wk = dense_sweep(batch, mu, phi_eff, phi_tot, cfg,
                                           layout, model,
                                           norm_phase="model_norm_loop",
                                           wbeta=wbeta)
                    phi_eff = phi_acc_wk + reducer.psum(
                        token_scatter_wk(batch.word_ids, c3 * mu, W, runs),
                        "dense_loop", w_rows=W, dtype=phi_wire)
                    phi_tot = _topic_totals(phi_eff, live_w)
                    theta = _theta(batch.counts, mu)
                    r_w = model.psum(
                        torch.sum(reducer.psum(r_wk, "dense_loop", w_rows=W,
                                               dtype=phi_wire), dim=1),
                        "model_rw_loop", compress=False, w_rows=W)
                    del r_wk
                t += 1

        # ---- Eq. (11): fold this batch's delta into the statistic,
        # written as the reference writes it, in phi_eff's (float32)
        # storage ----
        phi_acc_new = phi_eff.sub_(phi_acc_wk).mul_(delta_weight)
        if decay is None:
            phi_acc_new.add_(phi_acc_wk)
        else:
            # the decay's [W, K] pass is billed once per mini-batch
            reducer.bill(phi_acc_wk, "decay", w_rows=W)
            phi_acc_new.add_(decay * phi_acc_wk)
    if rec is not None:
        rec.count(iters=t, selective_iters=t - 1 if sync_mode == "power"
                  else 0, P=P, Pk=Pk, K=K)
        rec.tally(tokens=per_word.sum(), power_tokens=power_tokens)
    return MinibatchResult(phi_acc_new=phi_acc_new, iters=t,
                           mean_r=mean_residual(r_w, total_tokens), mu=mu,
                           theta=theta)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------
#
# Every execution mode runs ONE per-shard body, `pobp_shard_body`:
#   - `make_train_step`        the streaming step: one device, N = 1, or N
#                              data shards in lockstep (`run_stream` and
#                              `launch.lda_train --backend sim`)
#   - `make_sim_minibatch_fn`  one stateless mini-batch (tests, the chip
#                              smoke run)
#   - `make_mesh_shard_fn`     one shard a process of a DeviceMesh
#                              (`shard_map_minibatch_fn`,
#                              `launch.lda_train --backend shard_map`)

def pobp_shard_body(word_ids, counts, phi_acc, delta_weight: float,
                    cfg: LDAConfig, data_reducer: Reducer,
                    model_reducer: Optional[Reducer] = None,
                    sync_mode: str = "power", decay: Optional[float] = None,
                    *, live_w=None, generator=None, u0=None):
    """One shard's mini-batch routine: ``word_ids``/``counts`` are this
    shard's [Dl, L] documents, ``phi_acc`` the synchronized statistic over
    its topics; the global token count goes through the data reducer
    ("tokens" phase), then `pobp_minibatch` (``live_w`` as there).
    Returns (phi_acc_new, iters, mean_r, mu, theta)."""
    batch = MiniBatch(word_ids=word_ids, counts=counts)
    with data_reducer.meter.section():
        total = data_reducer.psum(torch.sum(counts), "tokens",
                                  compress=False)
    res = pobp_minibatch(batch, phi_acc, total, delta_weight, cfg,
                         data_reducer, model_reducer, sync_mode=sync_mode,
                         live_w=live_w, decay=decay, generator=generator,
                         u0=u0)
    return res.phi_acc_new, res.iters, res.mean_r, res.mu, res.theta


def _f32(x) -> float:
    return float(np.float32(x))


def _delta_weight(cfg: LDAConfig, m: int) -> float:
    """Eq. 11 weight for the (1-indexed) batch m, computed in float32 as
    the reference traces it."""
    if cfg.lr_schedule == "paper":
        return 1.0
    base = np.float32(cfg.lr_tau0) + np.float32(m)
    return _f32(base ** np.float32(-cfg.lr_kappa))


def _decay_factor(cfg: LDAConfig, m: int) -> Optional[float]:
    """Robbins-Monro retention 1 - (decay_tau0 + m)^-decay_kappa for batch
    m, in float32, or None when decay is off (decay_kappa == 0)."""
    if not cfg.decay_kappa:
        return None
    rho = (np.float32(cfg.decay_tau0) + np.float32(m)) ** np.float32(
        -cfg.decay_kappa)
    return _f32(np.float32(1.0) - rho)


def _topic_totals(phi_eff: torch.Tensor, live_w) -> torch.Tensor:
    """phi_tot [K], the column sums of phi_eff.  A live-W run sums the live
    rows only: the guard rows are exactly 0, so the value is the same, and
    the sum's order no longer depends on the rung (a grown run and a fresh
    run at its final rung sum alike)."""
    return torch.sum(phi_eff if live_w is None else phi_eff[:live_w], dim=0)


def _live_wbeta(cfg: LDAConfig, live_w: int) -> float:
    """The live-W smoothing mass float32(live_w) * float32(beta), as the
    reference traces it; refuses a live_w without a guard row above it."""
    if not 0 < int(live_w) < cfg.vocab_size:
        raise ValueError(f"live_w={live_w} must lie in [1, vocab_size="
                         f"{cfg.vocab_size}): the rung keeps a guard row "
                         f"above the live vocabulary")
    return _f32(np.float32(live_w) * np.float32(cfg.beta))


def _check_live_words(word_ids: torch.Tensor, live_w) -> None:
    """Every word id of a live-W batch is a live row: no token has a guard
    row's word (the dead power-word slots rely on it)."""
    if live_w is not None and word_ids.numel() and \
            int(word_ids.max()) >= int(live_w):
        raise ValueError(f"word id {int(word_ids.max())} is not below "
                         f"live_w={live_w}: the batch has a guard row's word")


def _check_ported(cfg: LDAConfig) -> None:
    """Raise ``ValueError`` for an unknown ``sweep_policy`` or
    ``phi_acc_dtype``."""
    resolve_sweep_policy(cfg)
    quantize.phi_acc_dtype(cfg)


def init_train_state(cfg: LDAConfig, seed: int = 0,
                     device="cuda") -> LDATrainState:
    """Cold-start state: phi_acc = 0 [W, K] at ``cfg.phi_acc_dtype`` on
    ``device`` (the accumulate still runs in float32: the state only
    stores narrow), m = 0, and a generator on that device seeded with
    ``seed``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return LDATrainState(
        phi_acc=torch.zeros((cfg.vocab_size, cfg.num_topics),
                            dtype=quantize.phi_acc_dtype(cfg), device=dev),
        m=0, generator=torch.Generator(device=dev).manual_seed(seed))


def grow_state(state: LDATrainState, new_vocab_cap: int) -> LDATrainState:
    """Grow-only capacity resize: `core.lifecycle.resize_state` without a
    fence (a shrink raises)."""
    from repro_torch.core.lifecycle import resize_state
    return resize_state(state, new_vocab_cap)


# tag of the stochastic-rounding generator, derived from the run's seed and
# the batch number so the run's own stream is never consumed (the
# reference's fold_in tag)
_SR_FOLD = 0x5F0C4


def _sr_generator(generator: torch.Generator, m: int) -> torch.Generator:
    """The generator of batch ``m``'s stochastic-rounding dither: seeded
    from ``generator.initial_seed()``, ``m`` and `_SR_FOLD`, so every f32
    run draws the same stream whether or not a bf16 run came between, and a
    resumed bf16 run draws what the uninterrupted one drew."""
    seed = (generator.initial_seed() * 0x9E3779B97F4A7C15
            + m * 0xBF58476D1CE4E5B9 + _SR_FOLD) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _shard_inits(batch: MiniBatch, num_shards: int, K: int, cfg: LDAConfig,
                 generator, u0: Optional[torch.Tensor], device) -> list:
    """The N shards' random inits, [Dl, Lpad, K] each, drawn from
    ``generator`` in shard order on the calling thread (the reference
    splits its key before the vmap), or ``u0`` [N, Dl, Lpad, K]
    unstacked."""
    shape = _init_shape(batch, K, cfg)
    if u0 is None:
        return [_uniform_init(shape, generator, device)
                for _ in range(num_shards)]
    if tuple(u0.shape) != (num_shards,) + shape:
        raise ValueError(f"u0 must have shape {(num_shards,) + shape}, got "
                         f"{tuple(u0.shape)}")
    return list(u0.to(device=device, dtype=torch.float32).unbind(0))


def _lockstep_reducer(reducer: Reducer) -> Optional[SimReducer]:
    """The `SimReducer` that runs a data reducer's shards in lockstep: the
    reducer itself, or the one a `PSReducer` bills around; else None."""
    if isinstance(reducer, PSReducer):
        reducer = reducer.inner
    return reducer if isinstance(reducer, SimReducer) else None


def _lockstep_minibatch(word_ids, counts, phi_acc, delta_weight, cfg,
                        reducer: Reducer, sync_mode: str, decay,
                        generator, u0, live_w=None) -> list:
    """`pobp_shard_body` on each of the N data shards of ``word_ids``/
    ``counts`` [N, Dl, L] in lockstep, through ``reducer`` (a `SimReducer`
    over the N, or a `PSReducer` around one); the shards' results in
    shard order."""
    sim = _lockstep_reducer(reducer)
    N = sim.num_shards
    if word_ids.dim() != 3 or word_ids.shape[0] != N:
        raise ValueError(f"word_ids must be [N={N}, Dl, L], got "
                         f"{tuple(word_ids.shape)}")
    dev = phi_acc.device
    inits = _shard_inits(MiniBatch(word_ids[0], counts[0]), N,
                         phi_acc.shape[1], cfg, generator, u0, dev)
    rec = obs.active()

    def body(n: int):
        with obs.shard(rec, n):
            return pobp_shard_body(word_ids[n], counts[n], phi_acc,
                                   delta_weight, cfg, reducer,
                                   sync_mode=sync_mode, decay=decay,
                                   live_w=live_w, u0=inits[n])

    return lockstep(body, N, [sim], dev)


def make_train_step(cfg: LDAConfig, num_shards: int = 1,
                    sync_mode: str = "power", sync_dtype=torch.float32, *,
                    reducer: Optional[Reducer] = None, device="cuda"):
    """The streaming step: one POBP mini-batch, on one shard or on
    ``num_shards`` data shards in lockstep on one device.

    The reference's positional order: ``sync_dtype`` (a torch dtype or its
    name) is the payload dtype of the compressed syncs; with one shard they
    take its cast round trip, so an N = 1 run computes what an N-shard run
    with that sync dtype computes.  Returns (step, meter) with
    ``step(state, word_ids, counts, live_w=None, *, u0=None) -> (new_state,
    diag)``; word_ids/counts are [D, L], or [N, Dl, L] with N shards (moved
    to the device); ``live_w`` (the reference's trailing argument) is the
    live vocabulary of a capacity-laddered run whose ``cfg.vocab_size`` is
    the current rung, every word id below it (checked); a rung crossing
    takes `grow_state` and a step made for the new rung's cfg.  ``diag =
    {iters, mean_r, theta}`` with ``mean_r`` and theta
    left on the device, theta [N, Dl, K] with N shards.  The step draws
    the init from ``state.generator`` (advancing it; with N shards each
    shard's [Dl, Lpad, K] in shard order) unless ``u0`` [D, Lpad, K] (or
    [N, Dl, Lpad, K]) is injected.  The new state's phi_acc is a new
    tensor at ``cfg.phi_acc_dtype`` (shard 0's: the shards' are identical
    bit for bit), folded back from the float32 accumulate by stochastic
    rounding when that is bfloat16; the old one is left unchanged.
    ``reducer`` injects the data reducer (when N > 1 a `SimReducer` over
    the N shards, or a `PSReducer` around one: each lockstep shard then
    bills the server's push and pull legs, and only the `PSReducer`
    records); its meter is the step's.
    """
    _check_ported(cfg)
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"unknown sync_mode: {sync_mode}")
    dev = resolve_device(device)
    if reducer is None:
        meter = CommMeter()
        reducer = (LocalReducer(meter=meter, sync_dtype=sync_dtype)
                   if num_shards == 1 else
                   SimReducer(num_shards, meter=meter, sync_dtype=sync_dtype))
    elif num_shards > 1 and getattr(_lockstep_reducer(reducer),
                                    "num_shards", None) != num_shards:
        raise ValueError(f"an injected reducer over {num_shards} shards "
                         f"must be a SimReducer of {num_shards} shards (or a "
                         f"PSReducer around one), got {reducer!r}")
    meter = reducer.meter
    storage = quantize.phi_acc_dtype(cfg)

    def step(state: LDATrainState, word_ids, counts, live_w=None, *,
             u0=None):
        here = state.phi_acc.device
        if here.type != dev.type or dev.index not in (None, here.index):
            raise ValueError(f"state.phi_acc is on {state.phi_acc.device}, "
                             f"the step on {dev}")
        if live_w is not None:
            live_w = int(live_w)
            _live_wbeta(cfg, live_w)
            _check_live_words(word_ids, live_w)
        m = state.m + 1
        with obs.step():
            wid = word_ids.to(here, torch.int32)
            cnt = counts.to(here, torch.float32)
            if num_shards == 1:
                phi, iters, mean_r, mu, theta = pobp_shard_body(
                    wid, cnt, state.phi_acc, _delta_weight(cfg, m), cfg,
                    reducer, sync_mode=sync_mode,
                    decay=_decay_factor(cfg, m), live_w=live_w,
                    generator=state.generator, u0=u0)
                del mu          # freed before the rounding allocates
            else:
                outs = _lockstep_minibatch(
                    wid, cnt, state.phi_acc, _delta_weight(cfg, m), cfg,
                    reducer, sync_mode, _decay_factor(cfg, m),
                    state.generator, u0, live_w)
                phi, iters, mean_r = outs[0][:3]
                theta = torch.stack([o[4] for o in outs])
                del outs        # the other shards' phi_acc freed here
            if storage != torch.float32:
                phi = quantize.stochastic_round(
                    phi, storage, _sr_generator(state.generator, m))
        return (LDATrainState(phi_acc=phi, m=m, generator=state.generator),
                dict(iters=iters, mean_r=mean_r, theta=theta))

    return step, meter


def make_sim_minibatch_fn(cfg: LDAConfig, num_shards: int,
                          sync_mode: str = "power", sync_dtype=torch.float32,
                          *, device="cuda"):
    """One stateless mini-batch on ``num_shards`` data shards in lockstep on
    one device (the reference's vmap simulation).  Returns (fn, meter)
    with ``fn(word_ids, counts, phi_acc, delta_weight, *, generator=None,
    u0=None) -> (phi_acc_new, iters, mean_r, mu, theta)``: with one shard
    the inputs are [D, L] and the outputs `pobp_shard_body`'s; with N they
    are [N, Dl, L] and every output carries a leading N axis (phi_acc_new
    [N, W, K], iters an int64 [N] tensor), so a test can read that the
    shards agree.  ``u0`` [N, Dl, Lpad, K] replaces the shards' draws."""
    _check_ported(cfg)
    dev = resolve_device(device)
    meter = CommMeter()
    red = (LocalReducer(meter=meter, sync_dtype=sync_dtype)
           if num_shards == 1 else
           SimReducer(num_shards, meter=meter, sync_dtype=sync_dtype))

    def fn(word_ids, counts, phi_acc, delta_weight, *, generator=None,
           u0=None):
        wid = word_ids.to(dev, torch.int32)
        cnt = counts.to(dev, torch.float32)
        phi_acc = phi_acc.to(dev)
        if num_shards == 1:
            return pobp_shard_body(wid, cnt, phi_acc, delta_weight, cfg, red,
                                   sync_mode=sync_mode, generator=generator,
                                   u0=u0)
        outs = _lockstep_minibatch(wid, cnt, phi_acc, delta_weight, cfg, red,
                                   sync_mode, None, generator, u0)
        phi, iters, mean_r, mu, theta = zip(*outs)
        return (torch.stack(phi), torch.tensor(iters), torch.stack(mean_r),
                torch.stack(mu), torch.stack(theta))

    return fn, meter


def mesh_data_index(mesh) -> Tuple[int, int]:
    """(this rank's index among the data shards, their count): the
    ``pod`` and ``data`` coordinates of ``mesh`` flattened, pod major."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for name, size, c in zip(names, mesh.shape, coord):
        if name in ("pod", "data"):
            index, count = index * size + c, count * size
    return index, count


def make_mesh_shard_fn(cfg: LDAConfig, mesh, sync_mode: str = "power",
                       sync_dtype=torch.float32,
                       meter: Optional[CommMeter] = None,
                       with_decay: bool = False, reducer_factory=None):
    """This rank's POBP body on a ``DeviceMesh``: documents split over the
    ``data`` (and ``pod``) axes, topics over ``model``.  Returns (local_fn,
    meter) with ``local_fn(word_ids [Dl, L], counts, phi_acc [W, Kl],
    delta_weight, *, generator=None, u0=None) -> (phi_acc_new, iters,
    mean_r)``; ``with_decay=True`` inserts the Robbins-Monro retention
    after ``delta_weight``.  The data psums run over the data axes'
    group, the model psums over the model axis's, so every rank of the
    mesh must call ``local_fn`` in step.  ``reducer_factory(group, meter,
    sync_dtype) -> Reducer`` replaces the data reducer; the model reducer
    is always a `MeshReducer`.  Creating it is collective (new process
    groups): every rank calls it."""
    _check_ported(cfg)
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in names if a in ("pod", "data"))
    meter = meter or CommMeter()
    group = mesh_axis_group(mesh, dp)
    data_red = (reducer_factory(group, meter, sync_dtype)
                if reducer_factory is not None else
                MeshReducer(group, meter=meter, sync_dtype=sync_dtype))
    model_red = (MeshReducer(mesh_axis_group(mesh, ("model",)), meter=meter,
                             sync_dtype=sync_dtype)
                 if "model" in names else None)

    def run(wid, cnt, phi_acc, delta_weight, decay, generator, u0):
        phi, iters, mean_r, _, _ = pobp_shard_body(
            wid, cnt, phi_acc, delta_weight, cfg, data_red, model_red,
            sync_mode=sync_mode, decay=decay, generator=generator, u0=u0)
        return phi, iters, mean_r

    if with_decay:
        def local(wid, cnt, phi_acc, delta_weight, decay, *, generator=None,
                  u0=None):
            return run(wid, cnt, phi_acc, delta_weight, decay, generator, u0)
    else:
        def local(wid, cnt, phi_acc, delta_weight, *, generator=None,
                  u0=None):
            return run(wid, cnt, phi_acc, delta_weight, None, generator, u0)
    return local, meter


def shard_map_minibatch_fn(cfg: LDAConfig, mesh, sync_mode: str = "power",
                           sync_dtype=torch.float32,
                           meter: Optional[CommMeter] = None,
                           with_decay: bool = False):
    """`make_mesh_shard_fn` with the reference's partition specs, one rank
    a mesh position: ``fn(word_ids [D, L], counts [D, L], phi_acc [W, Kl],
    delta_weight[, decay], *, generator=None, u0=None) -> (phi_acc_new
    [W, Kl], iters, mean_r)`` takes the global batch, runs this rank's
    slice of documents (its data index, `mesh_data_index`) against its
    topic columns of phi_acc, and returns them.  Each rank draws its init
    [Dl, Lpad, Kl] from its own ``generator``; seeded alike, every rank
    draws the same field, as the reference draws one replicated key under
    shard_map.  Returns (fn, meter)."""
    local, meter = make_mesh_shard_fn(cfg, mesh, sync_mode, sync_dtype,
                                      meter, with_decay=with_decay)
    index, count = mesh_data_index(mesh)

    def fn(word_ids, counts, phi_acc, delta_weight, *decay, generator=None,
           u0=None):
        D = word_ids.shape[0]
        if D % count:
            raise ValueError(f"a batch of {D} documents does not divide over "
                             f"{count} data shards")
        docs = slice(index * (D // count), (index + 1) * (D // count))
        dev = phi_acc.device
        return local(word_ids[docs].to(dev, torch.int32),
                     counts[docs].to(dev, torch.float32), phi_acc,
                     delta_weight, *decay, generator=generator, u0=u0)

    return fn, meter


class DiagBuffer:
    """Buffers per-batch scalars (device tensors or numbers) and reads them
    back to host values in blocks, so the stream does not wait on the
    device once per batch."""

    def __init__(self, block: int = 64):
        self.block = max(int(block), 1)
        self._pending: list = []
        self._done: list = []

    def append(self, *vals) -> None:
        self._pending.append(vals)
        if len(self._pending) >= self.block:
            self.flush()

    def flush(self) -> None:
        self._done.extend(
            tuple(v.item() if isinstance(v, torch.Tensor) else v
                  for v in vals)
            for vals in self._pending)
        self._pending.clear()

    def rows(self) -> list:
        self.flush()
        return self._done


def run_stream(stream, cfg: LDAConfig, num_shards: int = 1,
               sync_mode: str = "power", seed: int = 0,
               sync_dtype=torch.float32, callback=None,
               state: Optional[LDATrainState] = None, device="cuda"):
    """The outer ``for m`` loop of Fig. 4 over a stream of MiniBatches
    ([D, L], or [N, Dl, L] stacked with N shards:
    ``data.batching.sharded_minibatch_stream``).

    ``callback(m, phi_acc, rec, theta)`` (if given) sees each batch's
    result, with device scalars in ``rec``.  Pass ``state`` to continue a
    run.  Returns (phi_acc [W, K], history list of per-batch dicts, meter).
    """
    step, meter = make_train_step(cfg, num_shards, sync_mode, sync_dtype,
                                  device=device)
    if state is None:
        state = init_train_state(cfg, seed, device=device)
    buf = DiagBuffer()
    for m, batch in enumerate(stream, start=state.m + 1):
        state, diag = step(state, batch.word_ids, batch.counts)
        buf.append(m, diag["iters"], diag["mean_r"])
        if callback is not None:
            callback(m, state.phi_acc,
                     dict(m=m, iters=diag["iters"], mean_r=diag["mean_r"]),
                     diag["theta"])
    history = [dict(m=int(m), iters=int(it), mean_r=float(r))
               for m, it, r in buf.rows()]
    return state.phi_acc, history, meter
