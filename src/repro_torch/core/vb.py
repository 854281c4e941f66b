"""Variational Bayes for LDA (Blei et al. 2003), the paper's PVB
comparator: the counterpart of ``repro.core.vb``.

Mean-field coordinate ascent on the token-major runtime: the padded-CSR
batch flattens to the TokenLayout once, the per-token variational
posterior (resp) is a flat [T, K] stream with the digamma weights of phi
gathered per token, and every per-document reduction is a counts
contraction.

  E-step: gamma_d via digamma responsibilities over [T, K];
  M-step: lambda = beta + sum_t c_t * resp_t (the token scatter).

The E-step is plain PyTorch (``torch.digamma``, ``torch.logsumexp``, an
einsum), as the reference's is plain jnp.  The statistic goes through
``core/residuals.py::token_scatter_wk``: on the card the fixed-order
``word_rows_sum`` kernel over the layout's word runs, so a run repeats
bit for bit.  The parallel variant syncs the dense lambda matrix each
iteration (the pattern that gives PVB the worst communication bill in
Fig. 10: float payload, full matrix, every iteration).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.residuals import token_scatter_wk
from repro_torch.core.types import LDAConfig, MiniBatch, TokenLayout


def _e_step_tokens(layout: TokenLayout, counts2: torch.Tensor,
                   elog_phi_tok: torch.Tensor, cfg: LDAConfig,
                   inner: int = 8):
    """Per-document gamma updates with the phi weights fixed, token-major.

    ``elog_phi_tok`` [T, K] is the per-token digamma weight, gathered once
    per sweep (phi is fixed across the inner gamma iterations).  Returns
    (gamma [D, K], resp [T, K]).
    """
    D, L = layout.num_docs, layout.max_len
    K = elog_phi_tok.shape[-1]
    total = torch.sum(layout.counts)
    gamma = torch.zeros((D, K), device=counts2.device) + (
        cfg.alpha + total / (D * K))
    resp = None
    for _ in range(inner):
        elog_theta = torch.digamma(gamma) - torch.digamma(
            gamma.sum(-1, keepdim=True))                          # [D, K]
        logr = (elog_theta[:, None, :] + elog_phi_tok.view(D, L, K)
                ).view(layout.num_slots, K)                       # [T, K]
        logr = logr - torch.logsumexp(logr, -1, keepdim=True)
        resp = torch.exp(logr)
        del logr
        gamma = cfg.alpha + torch.einsum("dl,dlk->dk", counts2,
                                         resp.view(D, L, K))
    return gamma, resp


def vb_sweep(batch: MiniBatch, lam_wk: torch.Tensor, cfg: LDAConfig):
    """One batch-VB iteration: the E-step, then the lambda statistic (the
    M-step's input).  Returns (gamma [D, K], stat [W, K]); the batch lies
    on lam_wk's device."""
    layout = batch.token_layout()
    counts2 = layout.counts.reshape(layout.num_docs, layout.max_len)
    elog_phi = torch.digamma(lam_wk) - torch.digamma(
        lam_wk.sum(0, keepdim=True))
    elog_phi_tok = elog_phi.index_select(0, layout.word_ids.long())  # [T, K]
    del elog_phi
    gamma, resp = _e_step_tokens(layout, counts2, elog_phi_tok, cfg)
    del elog_phi_tok
    stat = token_scatter_wk(layout.word_ids, resp.mul_(layout.counts),
                            lam_wk.shape[0],
                            runs=layout.word_runs(lam_wk.shape[0]))
    return gamma, stat


def _initial_lam(generator, lam0, cfg: LDAConfig, dev) -> torch.Tensor:
    """``lam0`` (injected), or beta + uniform(0.5, 1.5) [W, K] from
    ``generator``, as the reference draws it."""
    if lam0 is not None:
        return lam0.to(device=dev, dtype=torch.float32)
    if generator is None:
        raise ValueError("the initial lambda needs a torch.Generator, or "
                         "lam0 injected")
    u = torch.rand((cfg.vocab_size, cfg.num_topics), generator=generator,
                   device=dev)
    return cfg.beta + (u + 0.5)


def run_vb(generator: Optional[torch.Generator], batch: MiniBatch,
           cfg: LDAConfig, iters: int, *, lam0: Optional[torch.Tensor] = None,
           device="cuda"):
    """Batch VB.  Returns (phi_hat [W, K] = lambda - beta, gamma [D, K]).

    ``lam0`` [W, K] is the initial lambda (the reference's beta +
    uniform(0.5, 1.5) draw), else drawn from ``generator`` on ``device``.
    """
    dev = resolve_device(device)
    batch = MiniBatch(batch.word_ids.to(dev), batch.counts.to(dev))
    lam = _initial_lam(generator, lam0, cfg, dev)
    gamma = None
    for _ in range(iters):
        gamma, stat = vb_sweep(batch, lam, cfg)
        lam = cfg.beta + stat
    return lam - cfg.beta, gamma


def run_parallel_vb(generator: Optional[torch.Generator],
                    batches: Sequence[MiniBatch], cfg: LDAConfig, iters: int,
                    *, lam0: Optional[torch.Tensor] = None, device="cuda"):
    """PVB: per-shard E-steps, dense lambda sync each iteration.

    Returns (phi_hat, comm_bytes): comm is the full float matrix per shard
    per iteration (cf. Fig. 10's worst case).
    """
    dev = resolve_device(device)
    batches = [MiniBatch(b.word_ids.to(dev), b.counts.to(dev))
               for b in batches]
    lam = _initial_lam(generator, lam0, cfg, dev)
    comm_bytes = 0
    for _ in range(iters):
        stat = torch.zeros_like(lam)
        for b in batches:
            _, s = vb_sweep(b, lam, cfg)
            stat += s
            del s
        lam = cfg.beta + stat
        comm_bytes += lam.numel() * 4 * len(batches)
    return lam - cfg.beta, comm_bytes
