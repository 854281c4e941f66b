"""The packed-stream selective sweep: its CUDA kernel's wrapper and its
plain PyTorch version.

`power_sweep_tokens` is the port's counterpart of the JAX package's TPU
kernel ``kernels/power_sweep/kernel.py::power_sweep_tokens`` (through
``ops.py::power_sweep``) together with the jnp code its caller wraps
around it on the packed path (``core/pobp.py``: the [T, Pk] gathers of
``_gather_selection`` and the fold-back of ``_apply_token_update``).  The
port's function takes the token stream, the carried messages, theta and
the packed phi, and returns the updated messages with theta's delta and
the packed delta/residual buffers: the kernel gathers by index and stores
back by index, so no [T, K] fold-back exists outside it, and the TPU tile
padding (a guard row in phi_pack, lanes to 128) is not needed.  It visits
the tokens in a sweep order (`sweep_order`, once per mini-batch on the
training path: ``TokenLayout.sweep_order``) in which each power row's
counted tokens are contiguous, so the packed sums are segmented sums in a
fixed order, with no atomics.

On a CUDA tensor it launches the hand-written kernel
(``csrc/power_sweep_tokens.cu``) and raises if the kernel cannot build or
launch; on a CPU tensor it runs `power_sweep_tokens_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check_args, device_int, launcher
from repro_torch.kernels.token_order import sweep_order

_SOURCE = "power_sweep_tokens"
_MAX_FOLD_WARPS = 4


def _fold_warps(device: torch.device, K: int) -> int:
    """Warps of the theta_delta fold at K topics: each keeps a [K] row in
    shared memory, up to 4 within what a block may opt in to."""
    optin = device_int(_SOURCE, "power_sweep_tokens_smem_optin", device)
    warps = min(_MAX_FOLD_WARPS, optin // (4 * max(K, 1)))
    if warps < 1:
        raise ValueError(f"K={K}: the packed sweep's fold takes K <= "
                         f"{optin // 4} on {device} (its shared memory)")
    return warps


def gather_selection(doc_ids, mu_t, theta, phi_tot, sel_k, p_safe):
    """Per-token [T, Pk] gathers at the selected coordinates: the
    counterpart of the reference's ``core/pobp.py::_gather_selection``.
    ``p_safe`` [T] is each token's packed row, 0 for a guard token.
    Returns (k_tok, mu_sel, theta_sel, pt_sel), k_tok int64."""
    k_tok = sel_k.long()[p_safe]
    return (k_tok, mu_t.gather(1, k_tok), theta[doc_ids.long()[:, None], k_tok],
            phi_tot[k_tok])


def apply_token_update(doc_ids, counts_t, mu_t, theta, k_tok, mu_sel,
                       mu_new_sel, power):
    """Fold the [T, Pk] update back: the counterpart of the reference's
    ``core/pobp.py::_apply_token_update``, in the kernel's form.  The power
    tokens' new messages are stored by index into ``mu_t`` IN PLACE (every
    other element is left as it was, bit for bit, where the reference adds
    exact zeros through a compare-select chain over [T, K]); theta is not
    touched: its delta, the per-document sum of c*dmu, is returned.
    Returns (theta_delta [D, K], d_mu [T, Pk])."""
    d_mu = mu_new_sel - mu_sel                      # 0 off the power tokens
    rows = power.nonzero().squeeze(1)
    mu_t[rows[:, None], k_tok[rows]] = mu_new_sel[rows]
    K = theta.shape[1]
    flat = doc_ids.long()[rows, None] * K + k_tok[rows]
    theta_delta = torch.zeros_like(theta)
    theta_delta.view(-1).index_add_(
        0, flat.reshape(-1), (counts_t[rows] * d_mu[rows]).reshape(-1))
    return theta_delta, d_mu


def power_sweep_tokens_plain(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                             phi_pack, sel_k, *, alpha: float, beta: float,
                             wbeta: float, onehot: bool = False, order=None):
    """The packed sweep in plain PyTorch ops: the reference's
    ``_gather_selection``, the math of
    ``kernels/power_sweep/ref.py::power_sweep_tokens_ref`` and
    ``_apply_token_update``, composed as the reference's packed path
    composes them.

    The packed [P, Pk] delta/residual sums run as the reference's
    ``_selective_sweep_packed`` runs them: a one-hot [T, P] contraction
    when ``onehot``, else a row ``index_add_``.  Guard tokens (a row id
    outside [0, P)) have exactly zero deltas either way.  ``order`` is the
    kernel's visiting order, not needed here.  ``mu_t`` is updated IN
    PLACE; returns (mu_t, theta_delta [D, K], d_pack [P, Pk], r_pack
    [P, Pk]).
    """
    P = sel_k.shape[0]
    p = p_tok.long()
    power = (p >= 0) & (p < P)
    p_safe = torch.where(power, p, 0)
    k_tok, mu_sel, theta_sel, pt_sel = gather_selection(
        doc_ids, mu_t, theta, phi_tot, sel_k, p_safe)
    phi_sel = phi_pack[p_safe]
    self_c = counts_t * mu_sel
    th = theta_sel - self_c + alpha
    ph = phi_sel - self_c + beta
    pt = pt_sel - self_c + wbeta
    u = th * ph / pt
    mass = torch.sum(mu_sel, dim=-1, keepdim=True)
    mu_new_sel = u * mass / torch.sum(u, dim=-1, keepdim=True).clamp_min(1e-30)
    mu_new_sel = torch.where(power[:, None], mu_new_sel, mu_sel)
    theta_delta, d_mu = apply_token_update(doc_ids, counts_t, mu_t, theta,
                                           k_tok, mu_sel, mu_new_sel, power)
    cd, rv = counts_t * d_mu, counts_t * torch.abs(d_mu)
    if onehot:
        oh = (p[:, None] == torch.arange(P, device=p.device)[None, :]
              ).to(cd.dtype)
        return mu_t, theta_delta, oh.T @ cd, oh.T @ rv
    zeros = torch.zeros((P, sel_k.shape[1]), dtype=cd.dtype, device=cd.device)
    return (mu_t, theta_delta, zeros.index_add(0, p[power], cd[power]),
            zeros.index_add(0, p[power], rv[power]))


@launcher(_SOURCE, "mu_t", power_sweep_tokens_plain)
def power_sweep_tokens(kernel, stream, p_tok, doc_ids, counts_t, mu_t, theta,
                       phi_tot, phi_pack, sel_k, *, alpha: float,
                       beta: float, wbeta: float, onehot: bool = False,
                       order=None):
    """One packed selective sweep over the token-major messages.

    p_tok [T] int32: each token's row of the packed buffers, P (the guard
    id) for a token of a word that is not a power word; doc_ids [T] int32,
    non-decreasing (tokens doc-contiguous);
    counts_t [T, 1]; mu_t [T, K], updated IN PLACE at the power tokens'
    selected topics only; theta [D, K], read only (every token sees it as
    it was: the sweep is Jacobi); phi_tot [K]; phi_pack [P, Pk] the packed
    effective phi (no guard row); sel_k [P, Pk] int32 each power word's
    topics, distinct within a row.  A row no token maps to (a live-W
    selection's dead slots, which repeat one zero guard row of phi: the
    same topics, a zero phi_pack row) gets d/r rows of exact zeros.
    ``onehot`` picks the plain version's
    packed accumulation (the reference's ``onehot_crossover``); the kernel
    ignores it, as the TPU kernel does.  ``order`` [T] int32 is the
    kernel's sweep order (`sweep_order` of the tokens' words or rows, made
    once per mini-batch): a permutation of the tokens in which each power
    row's counted tokens are contiguous.  It is built from ``p_tok`` when
    not given; the plain version does not need it.

    Returns (mu_t, theta_delta [D, K], d_pack [P, Pk], r_pack [P, Pk]); the
    caller forms theta + theta_delta.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (two device kernels), counted
    once as ``power_sweep_tokens``.  The kernel sums in a fixed
    order, so all four outputs repeat bit for bit from launch to launch.
    doc_ids, sel_k and order must be in range: the kernel reads them
    unchecked.
    """
    T, K = mu_t.shape
    D = theta.shape[0]
    P, Pk = sel_k.shape
    if order is None:
        power = (p_tok >= 0) & (p_tok < P)
        order = sweep_order(torch.where(power, p_tok, P), counts_t)
    check_args("mu_t", {"p_tok": (p_tok, torch.int32, (T,)),
                        "order": (order, torch.int32, (T,)),
                        "doc_ids": (doc_ids, torch.int32, (T,)),
                        "counts_t": (counts_t, torch.float32, (T, 1)),
                        "mu_t": (mu_t, torch.float32, (T, K)),
                        "theta": (theta, torch.float32, (D, K)),
                        "phi_tot": (phi_tot, torch.float32, (K,)),
                        "phi_pack": (phi_pack, torch.float32, (P, Pk)),
                        "sel_k": (sel_k, torch.int32, (P, Pk))})
    if Pk > K:
        raise ValueError(f"Pk={Pk} power topics exceed K={K}")
    dev = mu_t.device
    theta_delta = torch.empty_like(theta)
    packs = torch.zeros((2, P, Pk), dtype=torch.float32, device=dev)
    d_pack, r_pack = packs[0], packs[1]
    scratch = torch.empty(kernel.lib.power_sweep_tokens_scratch_words(T, Pk),
                          dtype=torch.float32, device=dev)
    kernel.launch(
        kernel.lib.power_sweep_tokens, order.data_ptr(), p_tok.data_ptr(),
        doc_ids.data_ptr(), counts_t.data_ptr(), mu_t.data_ptr(),
        theta.data_ptr(), phi_tot.data_ptr(), phi_pack.data_ptr(),
        sel_k.data_ptr(), scratch.data_ptr(), theta_delta.data_ptr(),
        d_pack.data_ptr(), r_pack.data_ptr(), T, D, K, P, Pk, float(alpha),
        float(beta), float(wbeta), _fold_warps(dev, K), stream)
    return mu_t, theta_delta, d_pack, r_pack
