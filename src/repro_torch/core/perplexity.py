"""Phi normalization and predictive perplexity (paper Eq. 20), the
counterpart of ``repro.core.perplexity``."""

from __future__ import annotations

import torch

from repro_torch.core.types import MiniBatch


def normalize_phi(phi_acc_wk: torch.Tensor, beta: float,
                  live_w=None) -> torch.Tensor:
    """phi[w, k] = (phi_hat + beta) / sum_w (phi_hat + beta), per topic.

    With ``live_w``, rows in [live_w, W) are guard rows: they are left out
    of the denominator and get the beta-prior mass beta/denom, which is
    what serving folds in for an unseen word.  Returns a new tensor.
    """
    out = phi_acc_wk + beta
    if live_w is None:
        return out.div_(out.sum(dim=0, keepdim=True))
    denom = out[:live_w].sum(dim=0, keepdim=True).clamp_min(1e-30)
    out[live_w:] = beta
    return out.div_(denom)


def predictive_perplexity(theta: torch.Tensor, phi_norm_wk: torch.Tensor,
                          test: MiniBatch) -> torch.Tensor:
    """Eq. (20) on the held-out split."""
    phi_tok = phi_norm_wk[test.word_ids.long()]                 # [D, L, K]
    p = torch.einsum("dk,dlk->dl", theta, phi_tok)
    logp = torch.where(test.counts > 0, torch.log(p.clamp_min(1e-30)), 0.0)
    n = torch.sum(test.counts).clamp_min(1.0)
    return torch.exp(-torch.sum(test.counts * logp) / n)
