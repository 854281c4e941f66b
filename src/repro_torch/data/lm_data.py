"""Deterministic synthetic LM token stream (counterpart of
``repro.data.lm_data``).

Tokens are Zipf-distributed (power-law marginals) with a learnable bigram
structure, so a trained LM has signal to fit.  The stream is a pure
function of (seed, step) drawn with numpy exactly as the reference draws
it, so the tokens are the reference's bit for bit and a checkpoint's data
cursor is just the step counter.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def _zipf_probs(vocab: int, s: float = 1.1) -> np.ndarray:
    p = np.arange(1, vocab + 1, dtype=np.float64) ** (-s)
    return (p / p.sum()).astype(np.float32)


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int,
             shards: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """The batch for a given step (a pure function, so restartable):
    int32 ``tokens`` and ``labels`` [batch, seq] on ``device``, or
    [shards, batch // shards, seq] when ``shards`` > 0."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    p = _zipf_probs(vocab)
    toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
    # inject bigram structure: every even position predicts (t*7+3) % vocab
    toks[:, 1::2] = (toks[:, 0:-1:2] * 7 + 3) % vocab
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if shards:
        out = {k: v.reshape(shards, batch // shards, seq)
               for k, v in out.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in out.items()}


def token_stream(seed: int, steps: int, batch: int, seq: int, vocab: int,
                 start_step: int = 0, shards: int = 0, device="cuda"
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    for step in range(start_step, steps):
        yield batch_at(seed, step, batch, seq, vocab, shards, device=device)
