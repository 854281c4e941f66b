"""Phi normalization and predictive perplexity (paper Eq. 20), the
counterpart of ``repro.core.perplexity``.

Protocol: per document, tokens are split 80/20; with phi fixed, theta is
folded in on the 80% split and perplexity is scored on the held-out 20%.
The fold-in is ``core.infer.fold_in_tokens``, the body serving runs, so on
the card scoring launches the serving mode of the carry-sweep kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import infer
from repro_torch.core.device import resolve_device
from repro_torch.core.types import LDAConfig, MiniBatch


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


def fold_in_theta(batch: MiniBatch, phi_norm_wk: torch.Tensor,
                  cfg: LDAConfig, iters: int = 30, residual_tol: float = 0.0,
                  *, generator: Optional[torch.Generator] = None,
                  mu0: Optional[torch.Tensor] = None,
                  device="cuda") -> torch.Tensor:
    """theta [D, K] of ``batch`` folded in with phi fixed (BP fold-in).

    ``residual_tol > 0`` lets each document stop early; 0 keeps the paper's
    fixed-sweep protocol.  ``mu0`` [D, L, K] replaces the random init drawn
    from ``generator``."""
    return infer.fold_in_tokens(batch, phi_norm_wk, cfg, iters=iters,
                                residual_tol=residual_tol,
                                generator=generator, mu0=mu0,
                                device=device).theta


def evaluate(phi_acc_wk: torch.Tensor, train: MiniBatch, test: MiniBatch,
             cfg: LDAConfig, fold_iters: int = 30, *,
             generator: Optional[torch.Generator] = None,
             mu0: Optional[torch.Tensor] = None, device="cuda",
             live_w=None) -> float:
    """Held-out predictive perplexity of ``phi_acc_wk`` [W, K]: normalize
    phi, fold theta in on ``train``, score ``test`` (Eq. 20).

    ``live_w`` scores a capacity-laddered phi at its live vocabulary
    (`normalize_phi`'s live mask): a held-out word the vocabulary has not
    seen, mapped by the caller to the first guard row (``live_w``), gets
    the beta-prior mass and scores finitely."""
    dev = resolve_device(device)
    phi_norm = normalize_phi(phi_acc_wk.to(dev, torch.float32), cfg.beta,
                             live_w=live_w)
    theta = fold_in_theta(train, phi_norm, cfg, iters=fold_iters,
                          generator=generator, mu0=mu0, device=dev)
    test = MiniBatch(test.word_ids.to(dev), test.counts.to(dev))
    return float(predictive_perplexity(theta, phi_norm, test))
