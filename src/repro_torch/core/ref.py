"""Plain reference implementation of belief propagation for LDA: the
counterpart of the JAX package's oracle ``repro.core.ref``.

Batch BP of Zeng et al. (paper ref [5]) with the synchronous (Jacobi)
schedule, the message update Eq. (1) with exact self-exclusion, the
sufficient statistics Eqs. (2)-(3) and the residuals Eq. (7).  No
selection, no streaming: deliberately simple and slow.  Tests hold the
port's POBP step against it and against the reference's own oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import LDAConfig, MiniBatch


def init_messages(batch: MiniBatch, K: int, *,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random normalized messages mu[D, L, K] (Fig. 4 line 3): U(0.01, 1)
    drawn from ``generator``, or the given field ``u`` [D, L, K]."""
    D, L = batch.word_ids.shape
    if u is None:
        u = torch.rand((D, L, K), generator=generator,
                       device=batch.counts.device) * (1.0 - 0.01) + 0.01
    return u / torch.sum(u, dim=-1, keepdim=True)


def theta_hat_from(batch: MiniBatch, mu: torch.Tensor) -> torch.Tensor:
    """Eq. (2), inclusive form: theta_hat[d, k] = sum_l c[d,l] mu[d,l,k]."""
    return torch.einsum("dl,dlk->dk", batch.counts, mu)


def phi_delta_from(batch: MiniBatch, mu: torch.Tensor, W: int
                   ) -> torch.Tensor:
    """The mini-batch's contribution to Eq. (3): Delta phi_hat[K, W]."""
    K = mu.shape[-1]
    weighted = (batch.counts[..., None] * mu).reshape(-1, K)
    out = torch.zeros((W, K), dtype=mu.dtype, device=mu.device)
    return out.index_add_(0, batch.word_ids.reshape(-1).long(), weighted).T


def bp_sweep(batch: MiniBatch, mu: torch.Tensor, phi_prior: torch.Tensor,
             cfg: LDAConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One synchronous BP sweep over all tokens.  ``phi_prior`` [K, W] is
    the statistic of earlier mini-batches.  Returns (mu_new, r_wk [W, K],
    theta_hat)."""
    K, W = cfg.num_topics, cfg.vocab_size
    theta = theta_hat_from(batch, mu)
    phi = phi_prior + phi_delta_from(batch, mu, W)
    phi_tot = torch.sum(phi, dim=1)
    c = batch.counts[..., None]
    self_c = c * mu
    th = theta[:, None, :] - self_c + cfg.alpha
    ph = phi.T[batch.word_ids.long()] - self_c + cfg.beta
    pt = phi_tot[None, None, :] - self_c + W * cfg.beta
    unnorm = th * ph / pt
    mu_new = unnorm / torch.sum(unnorm, dim=-1, keepdim=True)
    r_tok = (c * torch.abs(mu_new - mu)).reshape(-1, K)
    r_wk = torch.zeros((W, K), dtype=r_tok.dtype, device=r_tok.device)
    r_wk.index_add_(0, batch.word_ids.reshape(-1).long(), r_tok)
    return mu_new, r_wk, theta


def batch_bp(batch: MiniBatch, cfg: LDAConfig, iters: int,
             phi_prior: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None,
             u: Optional[torch.Tensor] = None):
    """Full batch BP: ``iters`` synchronous sweeps from the init of
    `init_messages`.  Returns (mu, phi_hat [K, W], theta_hat,
    residual_trace [iters])."""
    K, W = cfg.num_topics, cfg.vocab_size
    if phi_prior is None:
        phi_prior = torch.zeros((K, W), dtype=torch.float32,
                                device=batch.counts.device)
    mu = init_messages(batch, K, generator=generator, u=u)
    tokens = torch.sum(batch.counts).clamp_min(1.0)
    trace = []
    for _ in range(iters):
        mu, r_wk, _ = bp_sweep(batch, mu, phi_prior, cfg)
        trace.append(torch.sum(r_wk) / tokens)
    return (mu, phi_prior + phi_delta_from(batch, mu, W),
            theta_hat_from(batch, mu), torch.stack(trace))


def log_likelihood(batch: MiniBatch, theta: torch.Tensor, phi: torch.Tensor,
                   cfg: LDAConfig) -> torch.Tensor:
    """Token log-likelihood sum x log(sum_k theta_d(k) phi_w(k)) with the
    smoothed, normalized multinomials; theta [D, K], phi [K, W]."""
    theta_n = theta + cfg.alpha
    theta_n = theta_n / torch.sum(theta_n, dim=-1, keepdim=True)
    phi_n = phi + cfg.beta
    phi_n = phi_n / torch.sum(phi_n, dim=1, keepdim=True)
    p_tok = torch.einsum("dk,kdl->dl", theta_n,
                         phi_n[:, batch.word_ids.long()])
    logp = torch.where(batch.counts > 0,
                       torch.log(p_tok.clamp_min(1e-30)), 0.0)
    return torch.sum(batch.counts * logp)
