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
    (``scatter_add_rows``, through ``core.power``).

The reference's ``lax.while_loop`` is a Python loop here: each iteration
reads the mean residual back to the host once to decide whether to go on.
The port updates in place where that saves a [W, K] or [T, K] copy, and
says so per function.  One shard only: the multi-shard sync, live-W runs
and bf16 ``phi_acc`` raise (ROADMAP Queue 1, items 5, 6 and 2c).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import power as pw
from repro_torch.core.device import resolve_device
from repro_torch.core.residuals import (mean_residual, packed_rw_delta,
                                        token_scatter_wk)
from repro_torch.core.sweep_dispatch import resolve_sweep_policy
from repro_torch.core.sync import CommMeter, LocalReducer
from repro_torch.core.types import (LDAConfig, LDATrainState, MiniBatch,
                                    TokenLayout)
from repro_torch.kernels.bp_update.ops import bp_update
from repro_torch.kernels.power_sweep.ops import power_sweep_carry_train
from repro_torch.kernels.power_sweep.packed import power_sweep_tokens

SYNC_MODES = ("power", "dense")


def _theta(counts: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Eq. (2): theta[d, k] = sum_l c[d, l] mu[d, l, k], contiguous."""
    return torch.einsum("dl,dlk->dk", counts, mu).contiguous()


# --------------------------------------------------------------------------
# dense (full) sweep: Fig. 4 lines 3-8 and the `dense` sync mode
# --------------------------------------------------------------------------

def dense_sweep(batch: MiniBatch, mu: torch.Tensor, phi_eff_wk: torch.Tensor,
                phi_tot: torch.Tensor, cfg: LDAConfig,
                layout: Optional[TokenLayout] = None):
    """One synchronous full update of all messages (Eq. 1).

    mu [D, L, K]; phi_eff_wk [W, K] is the effective statistic (accumulated
    prior plus this mini-batch's contribution); phi_tot [K] its column sums.
    The topic axis is never sharded in the port, so the normalization runs
    inside ``bp_update`` (the reference's ``dense_sweep_pallas`` branch).
    Returns new tensors (mu_new [D, L, K], r_wk [W, K]).
    """
    layout = layout or batch.token_layout()
    D, L, K = mu.shape
    mu_new, r_tok = bp_update(
        layout.word_ids, layout.doc_ids, layout.counts,
        mu.reshape(D * L, K).contiguous(),
        _theta(batch.counts, mu), phi_eff_wk, phi_tot, alpha=cfg.alpha,
        beta=cfg.beta, wbeta=cfg.vocab_size * cfg.beta)
    return (mu_new.reshape(D, L, K),
            token_scatter_wk(layout.word_ids, r_tok, cfg.vocab_size))


# --------------------------------------------------------------------------
# token-major selective sweep: Fig. 4 lines 15-21
# --------------------------------------------------------------------------

def selective_sweep_tokens(layout: TokenLayout, mu_t, theta, phi_eff_wk,
                           phi_tot, sel_w, sel_k, cfg: LDAConfig,
                           policy: Optional[str] = None):
    """One selective sweep at the (power word, power topic) coordinates,
    in the formulation ``policy`` names (default: ``cfg.sweep_policy``
    resolved by ``resolve_sweep_policy``), as the reference's
    ``selective_sweep_tokens_pallas`` dispatches: ``packed`` runs
    `_selective_sweep_packed`, every other policy `_selective_sweep_carry`.
    The two compute the same sweep within float associativity.

    mu_t [T, K] token-major messages, updated IN PLACE; theta [D, K] the
    doc-topic statistic of mu_t; phi_eff_wk [W, K]; phi_tot [K]; sel_w
    [P]; sel_k [P, Pk].  Returns (mu_t, theta_new, d_pack [P, Pk],
    r_pack [P, Pk]).
    """
    policy = policy or resolve_sweep_policy(cfg)
    fn = (_selective_sweep_packed if policy == "packed"
          else _selective_sweep_carry)
    return fn(layout, mu_t, theta, phi_eff_wk, phi_tot, sel_w, sel_k, cfg)


def _selective_sweep_carry(layout: TokenLayout, mu_t, theta, phi_eff_wk,
                           phi_tot, sel_w, sel_k, cfg: LDAConfig):
    """The carry formulation, the reference's
    ``_selective_sweep_carry_pallas``: the training mode of the carry sweep
    (``power_sweep_carry_train``), which reads ``sel_w``, ``sel_k`` and phi
    directly where the reference builds [P+1, K] phi and mask row tables
    and reads its [P, K] delta/residual rows back at ``sel_k``."""
    p_tok = pw.token_power_rows(layout.word_ids, sel_w, cfg.vocab_size)
    mu_t, theta_delta, d_pack, r_pack = power_sweep_carry_train(
        p_tok, layout.doc_ids, layout.counts, mu_t, theta, phi_tot,
        phi_eff_wk, sel_w, sel_k, alpha=cfg.alpha, beta=cfg.beta,
        wbeta=cfg.vocab_size * cfg.beta)
    return mu_t, theta + theta_delta, d_pack, r_pack


def _selective_sweep_packed(layout: TokenLayout, mu_t, theta, phi_eff_wk,
                            phi_tot, sel_w, sel_k, cfg: LDAConfig):
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
        wbeta=cfg.vocab_size * cfg.beta,
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


def _draw_u0(batch: MiniBatch, K: int, cfg: LDAConfig, generator,
             u0: Optional[torch.Tensor], device) -> torch.Tensor:
    """The random message field U(0.01, 1) at [D, Lpad, K], sliced to L.

    ``Lpad`` honours ``cfg.init_pad_len`` as the reference does, so the
    init of a document does not depend on the L bucket its batch landed
    in.  ``u0`` [D, Lpad, K] replaces the draw from ``generator`` (tests
    inject the reference's ``jax.random.uniform`` draw)."""
    D, L = batch.word_ids.shape
    Lpad = L if cfg.init_pad_len is None else max(cfg.init_pad_len, L)
    if u0 is None:
        u0 = torch.rand((D, Lpad, K), generator=generator, device=device)
        u0 = u0 * (1.0 - 0.01) + 0.01
    elif tuple(u0.shape) != (D, Lpad, K):
        raise ValueError(f"u0 must have shape {(D, Lpad, K)}, got "
                         f"{tuple(u0.shape)}")
    return u0.to(device=device, dtype=torch.float32)[:, :L]


def pobp_minibatch(batch: MiniBatch, phi_acc_wk: torch.Tensor, total_tokens,
                   delta_weight: float, cfg: LDAConfig,
                   data_reducer: Optional[LocalReducer] = None,
                   sync_mode: str = "power", live_w=None,
                   decay: Optional[float] = None, *,
                   generator: Optional[torch.Generator] = None,
                   u0: Optional[torch.Tensor] = None) -> MinibatchResult:
    """Run one mini-batch to convergence (all Fig. 4 lines).

    ``batch`` holds [D, L] tensors on phi_acc's device; ``phi_acc_wk``
    [W, K] float32 is the accumulated statistic (left unchanged);
    ``total_tokens`` the mini-batch's token count; ``delta_weight`` the
    Eq. 11 weight on this batch's delta; ``decay`` (or None) the
    Robbins-Monro retention on the historical statistic.  The random init
    comes from ``generator``, or from an injected ``u0`` [D, Lpad, K].
    ``phi_acc_new`` reuses the storage of the step's working statistic
    ``phi_eff``; nothing the caller passed is modified.
    """
    if live_w is not None:
        raise NotImplementedError(
            "live_w: capacity-laddered (dynamic vocabulary) training is not "
            "ported yet (ROADMAP Queue 1, item 6)")
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"unknown sync_mode: {sync_mode}")
    if phi_acc_wk.dtype != torch.float32:
        raise NotImplementedError(
            f"phi_acc of dtype {phi_acc_wk.dtype}: compressed accumulators "
            f"are not ported yet (ROADMAP Queue 1, item 2c)")
    reducer = data_reducer or LocalReducer()
    dev = phi_acc_wk.device
    W = cfg.vocab_size
    K = phi_acc_wk.shape[1]
    P, Pk = cfg.num_power_words, min(cfg.num_power_topics, K)
    _check_ported(cfg)
    policy = resolve_sweep_policy(cfg)
    layout = batch.token_layout()
    c3 = batch.counts[..., None]

    # ---- lines 3-8: random init, local stats, first dense update ----
    u = _draw_u0(batch, K, cfg, generator, u0, dev)
    mu0 = u / torch.sum(u, -1, keepdim=True)
    del u
    phi_eff = phi_acc_wk + token_scatter_wk(batch.word_ids, c3 * mu0, W)
    phi_tot = torch.sum(phi_eff, dim=0)
    mu1, r_wk_local = dense_sweep(batch, mu0, phi_eff, phi_tot, cfg, layout)
    del mu0, phi_eff

    # ---- lines 9-10: dense synchronization of phi and r ----
    phi_eff = phi_acc_wk + reducer.psum(
        token_scatter_wk(batch.word_ids, c3 * mu1, W), "dense")
    phi_tot = torch.sum(phi_eff, dim=0)
    r_glob = reducer.psum(r_wk_local, "dense")
    del r_wk_local
    theta = _theta(batch.counts, mu1)
    r_w = torch.sum(r_glob, dim=1)

    def go_on(t: int, r_w: torch.Tensor) -> bool:
        # the one host read per iteration
        return t < cfg.inner_iters and \
            float(mean_residual(r_w, total_tokens)) > cfg.residual_tol

    t = 1
    if sync_mode == "power":
        mu_t = mu1.reshape(layout.num_slots, K)
        while go_on(t, r_w):
            sel_w = pw.select_power_words(r_w, P)
            sel_k = pw.select_power_topics(r_glob, sel_w, Pk)
            mu_t, theta, d_pack, r_pack = selective_sweep_tokens(
                layout, mu_t, theta, phi_eff, phi_tot, sel_w, sel_k, cfg,
                policy)
            # lines 23-24: sync only the power submatrices
            d_pack = reducer.psum(d_pack, "power")
            r_pack = reducer.psum(r_pack, "power")
            # packed-carry refresh, Eq. 9: O(P*Pk) updates, in place
            rw_delta = packed_rw_delta(r_glob, sel_w, sel_k, r_pack)
            pw.scatter_add_rows(phi_eff, sel_w, sel_k, d_pack)
            phi_tot = phi_tot + torch.zeros_like(phi_tot).index_add_(
                0, sel_k.reshape(-1).long(), d_pack.reshape(-1))
            pw.scatter_set_rows(r_glob, sel_w, sel_k, r_pack)
            rw_delta = reducer.psum(rw_delta, "model_rw_loop", compress=False)
            r_w = r_w.index_add(0, sel_w.long(), rw_delta)
            t += 1
        mu = layout.to_batch_major(mu_t)
    else:
        mu = mu1
        while go_on(t, r_w):
            mu, r_wk = dense_sweep(batch, mu, phi_eff, phi_tot, cfg, layout)
            phi_eff = phi_acc_wk + reducer.psum(
                token_scatter_wk(batch.word_ids, c3 * mu, W), "dense_loop")
            phi_tot = torch.sum(phi_eff, dim=0)
            theta = _theta(batch.counts, mu)
            r_w = torch.sum(reducer.psum(r_wk, "dense_loop"), dim=1)
            del r_wk
            t += 1

    # ---- Eq. (11): fold this batch's delta into the statistic, written
    # as the reference writes it, in phi_eff's storage ----
    phi_acc_new = phi_eff.sub_(phi_acc_wk).mul_(delta_weight)
    if decay is None:
        phi_acc_new.add_(phi_acc_wk)
    else:
        # the decay's [W, K] pass is billed once per mini-batch
        reducer.bill(phi_acc_wk, "decay")
        phi_acc_new.add_(decay * phi_acc_wk)
    return MinibatchResult(phi_acc_new=phi_acc_new, iters=t,
                           mean_r=mean_residual(r_w, total_tokens), mu=mu,
                           theta=theta)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def pobp_shard_body(word_ids, counts, phi_acc, delta_weight: float,
                    cfg: LDAConfig, data_reducer: LocalReducer,
                    sync_mode: str = "power", decay: Optional[float] = None,
                    *, generator=None, u0=None):
    """One shard's mini-batch routine: the token count goes through the
    reducer ("tokens" phase), then `pobp_minibatch`.  Returns (phi_acc_new,
    iters, mean_r, mu, theta)."""
    batch = MiniBatch(word_ids=word_ids, counts=counts)
    total = data_reducer.psum(torch.sum(counts), "tokens", compress=False)
    res = pobp_minibatch(batch, phi_acc, total, delta_weight, cfg,
                         data_reducer, sync_mode=sync_mode, decay=decay,
                         generator=generator, u0=u0)
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


def _check_ported(cfg: LDAConfig, num_shards: int = 1,
                  reducer=None) -> None:
    """Raise for what the port does not run yet, and (``ValueError``) for
    an unknown ``sweep_policy``."""
    resolve_sweep_policy(cfg)
    if num_shards != 1 or reducer is not None:
        raise NotImplementedError(
            f"num_shards={num_shards}, reducer={reducer!r}: multi-shard sync "
            f"and injected reducers are not ported yet (ROADMAP Queue 1, "
            f"item 5)")
    if cfg.phi_acc_dtype != "float32":
        raise NotImplementedError(
            f"phi_acc_dtype={cfg.phi_acc_dtype!r}: compressed accumulators "
            f"with stochastic rounding are not ported yet (ROADMAP Queue 1, "
            f"item 2c)")


def init_train_state(cfg: LDAConfig, seed: int = 0,
                     device="cuda") -> LDATrainState:
    """Cold-start state: phi_acc = 0 [W, K] float32 on ``device``, m = 0,
    and a generator on that device seeded with ``seed``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return LDATrainState(
        phi_acc=torch.zeros((cfg.vocab_size, cfg.num_topics),
                            dtype=torch.float32, device=dev),
        m=0, generator=torch.Generator(device=dev).manual_seed(seed))


def make_train_step(cfg: LDAConfig, num_shards: int = 1,
                    sync_mode: str = "power", reducer=None, device="cuda"):
    """The streaming step: one POBP mini-batch on one device.

    Returns (step, meter) with ``step(state, word_ids, counts, *, u0=None)
    -> (new_state, diag)``; word_ids/counts are [D, L] (moved to the
    device), ``diag = {iters, mean_r, theta}`` with ``mean_r`` and theta
    left on the device.  The step draws the init from ``state.generator``
    (advancing it) unless ``u0`` [D, Lpad, K] is injected.  The new
    state's phi_acc is a new tensor; the old one is left unchanged.
    """
    _check_ported(cfg, num_shards, reducer)
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"unknown sync_mode: {sync_mode}")
    dev = resolve_device(device)
    meter = CommMeter()
    red = LocalReducer(meter=meter)

    def step(state: LDATrainState, word_ids, counts, *, u0=None):
        here = state.phi_acc.device
        if here.type != dev.type or dev.index not in (None, here.index):
            raise ValueError(f"state.phi_acc is on {state.phi_acc.device}, "
                             f"the step on {dev}")
        m = state.m + 1
        phi, iters, mean_r, _mu, theta = pobp_shard_body(
            word_ids.to(here, torch.int32), counts.to(here, torch.float32),
            state.phi_acc, _delta_weight(cfg, m), cfg, red,
            sync_mode=sync_mode, decay=_decay_factor(cfg, m),
            generator=state.generator, u0=u0)
        return (LDATrainState(phi_acc=phi, m=m, generator=state.generator),
                dict(iters=iters, mean_r=mean_r, theta=theta))

    return step, meter


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
               sync_mode: str = "power", seed: int = 0, callback=None,
               state: Optional[LDATrainState] = None, device="cuda"):
    """The outer ``for m`` loop of Fig. 4 over a stream of MiniBatches.

    ``callback(m, phi_acc, rec, theta)`` (if given) sees each batch's
    result, with device scalars in ``rec``.  Pass ``state`` to continue a
    run.  Returns (phi_acc [W, K], history list of per-batch dicts, meter).
    """
    step, meter = make_train_step(cfg, num_shards, sync_mode, device=device)
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
