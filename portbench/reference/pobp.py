"""Plain PyTorch reference of one POBP mini-batch (the paper's Fig. 4 on
one processor): the judge of the training cells.

Written from the algorithm, in plain torch operations, with nothing of the
port or of the JAX package: the dense t = 1 sweep with self-excluded
messages (Eq. 1), the dense statistics (Eq. 3/4, 8), then while the mean
residual (line 26) stays above the tolerance and fewer than
``inner_iters`` iterations have run: the power words (the top ``P`` word
residuals, Eq. 10) and their power topics (each word's top ``Pk`` topic
residuals), one Jacobi sweep at those coordinates with the messages
renormalized over them, and the packed refresh of phi, its column sums and
the residuals (Eq. 6, 9); last, the fold of the batch's delta into the
statistic (Eq. 11, weight 1).

The random message field is U(0.01, 1) drawn from the caller's generator
at [D, L, K], as the step under test draws it from the same seed.
``dtype`` runs every tensor at a narrower width (the control).
"""

from __future__ import annotations

import torch


def init_messages(gen: torch.Generator, D: int, L: int, K: int
                  ) -> torch.Tensor:
    """The normalized random message field [D * L, K], float32."""
    u = torch.rand((D, L, K), generator=gen, device=gen.device)
    u = u * (1.0 - 0.01) + 0.01
    return (u / torch.sum(u, -1, keepdim=True)).reshape(D * L, K)


def minibatch(phi_acc: torch.Tensor, word_ids: torch.Tensor,
              counts: torch.Tensor, mu0: torch.Tensor, cfg: dict, *,
              dtype=torch.float32, block: int = 32768):
    """One mini-batch from ``phi_acc`` [W, K] over word_ids / counts
    [D, L] with initial messages ``mu0`` [D * L, K].

    Returns (phi_acc_new [W, K] float32, theta [D, K] float32, iters).
    ``cfg`` holds alpha, beta, lambda_w, lambda_k_abs, inner_iters and
    residual_tol.  Token blocks of ``block`` bound the dense sweep's
    temporaries."""
    W, K = phi_acc.shape
    D, L = word_ids.shape
    dev = phi_acc.device
    alpha, beta = float(cfg["alpha"]), float(cfg["beta"])
    P = max(1, int(round(cfg["lambda_w"] * W)))
    Pk = max(1, min(int(cfg["lambda_k_abs"]), K))
    wbeta = W * beta
    w_t = word_ids.reshape(-1).long()
    d_t = torch.arange(D, device=dev).repeat_interleave(L)
    c_t = counts.reshape(-1, 1).to(dtype)
    total = float(counts.sum())
    acc = phi_acc.to(dtype)
    mu = mu0.to(dtype)

    def doc_sums(m):
        return (c_t * m).reshape(D, L, K).sum(dim=1)

    def word_sums(vals_of_block):
        out = torch.zeros((W, K), dtype=dtype, device=dev)
        for t0 in range(0, D * L, block):
            out.index_add_(0, w_t[t0:t0 + block], vals_of_block(t0))
        return out

    # lines 3-8: local statistics of the random field, the dense sweep
    theta = doc_sums(mu)
    phi_eff = acc + word_sums(lambda t0: c_t[t0:t0 + block]
                              * mu[t0:t0 + block])
    phi_tot = phi_eff.sum(dim=0)
    mu1 = torch.empty_like(mu)
    r_glob = torch.zeros((W, K), dtype=dtype, device=dev)
    for t0 in range(0, D * L, block):
        sl = slice(t0, t0 + block)
        self_c = c_t[sl] * mu[sl]
        u = ((theta[d_t[sl]] - self_c + alpha)
             * (phi_eff[w_t[sl]] - self_c + beta)
             / (phi_tot - self_c + wbeta))
        mu1[sl] = u / u.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        r_glob.index_add_(0, w_t[sl], c_t[sl] * (mu1[sl] - mu[sl]).abs())
    mu = mu1
    del mu1, u, self_c
    # lines 9-10: the dense statistics after the sweep
    phi_eff = acc + word_sums(lambda t0: c_t[t0:t0 + block]
                              * mu[t0:t0 + block])
    phi_tot = phi_eff.sum(dim=0)
    theta = doc_sums(mu)
    r_w = r_glob.sum(dim=1)
    counted = (c_t[:, 0] > 0)
    row_of = torch.full((W,), -1, dtype=torch.long, device=dev)
    prange = torch.arange(P, device=dev)

    t = 1
    while t < int(cfg["inner_iters"]) and \
            float(r_w.float().sum()) / max(total, 1.0) > \
            float(cfg["residual_tol"]):
        sel_w = torch.topk(r_w, P).indices
        sel_k = torch.topk(r_glob[sel_w], Pk, dim=1).indices      # [P, Pk]
        row_of.fill_(-1)
        row_of[sel_w] = prange
        p_tok = row_of[w_t]
        tp = ((p_tok >= 0) & counted).nonzero().squeeze(1)
        p = p_tok[tp]
        ks = sel_k[p]                                             # [n, Pk]
        dd = d_t[tp][:, None]
        cc = c_t[tp]
        m = mu[tp[:, None], ks]
        self_c = cc * m
        u = ((theta[dd, ks] - self_c + alpha)
             * (phi_eff[w_t[tp][:, None], ks] - self_c + beta)
             / (phi_tot[ks] - self_c + wbeta))
        m_new = u * m.sum(dim=-1, keepdim=True) / \
            u.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        dm = cc * (m_new - m)
        mu[tp[:, None], ks] = m_new
        theta.index_put_((dd.expand_as(ks), ks), dm, accumulate=True)
        d_pack = torch.zeros((P, Pk), dtype=dtype, device=dev
                             ).index_add_(0, p, dm)
        r_pack = torch.zeros((P, Pk), dtype=dtype, device=dev
                             ).index_add_(0, p, dm.abs())
        rows = sel_w[:, None]
        rw_delta = (r_pack - r_glob[rows, sel_k]).sum(dim=1)
        phi_eff[rows, sel_k] += d_pack
        phi_tot.index_add_(0, sel_k.reshape(-1), d_pack.reshape(-1))
        r_glob[rows, sel_k] = r_pack
        r_w.index_add_(0, sel_w, rw_delta)
        t += 1
    new = (phi_eff.float() - phi_acc) * 1.0 + phi_acc
    return new, theta.float(), t
