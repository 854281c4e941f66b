"""Collapsed Gibbs sampling for LDA, the paper's GS-family comparator (PGS
[15] / PFGS [6] / PSGS [21] / YLDA [14] are all GS-based): the counterpart
of ``repro.core.gibbs``.

The token-level sequential sampler (the textbook Griffiths & Steyvers
chain) runs one sweep a launch of the hand-written kernel
``kernels/gibbs_sweep`` on the card, where the reference runs a
``lax.scan``.  The parallel variant follows the AD-LDA approximation of
Newman et al. [15]: shards sample independently against a stale global
word-topic count and sum their count deltas once a sweep, which is why
PGS "can yield only an approximate result" (§2) while BP-based sync is
exact.

Random draws: the reference splits PRNG keys, which torch cannot
reproduce.  Here the initial topics come from a ``torch.Generator`` on the
batch's device, and each sweep's Gumbel noise from the kernel's Philox,
keyed by a seed drawn once from that generator and the sweep's index.
Every draw can be injected instead: the initial ``z`` and each sweep's
[T, K] noise (``jax.random.categorical`` is Gumbel-max, so the reference's
draws are ``jax.random.gumbel`` of the per-token keys).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.kernels.gibbs_sweep.ops import gibbs_sweep as sweep_kernel


def tokens_from_batch(batch: MiniBatch):
    """Expand padded-CSR counts into flat (doc_id, word_id) token tensors,
    int32 [T] on the batch's device: slots in (d, l) order, each repeated
    ``count`` times (slots of count 0 emit nothing), the reference's
    order."""
    D, L = batch.word_ids.shape
    wid = batch.word_ids.reshape(-1).to(torch.int32)
    cnt = batch.counts.reshape(-1).to(torch.int64)
    doc = torch.arange(D, dtype=torch.int32,
                       device=wid.device).repeat_interleave(L)
    keep = cnt > 0
    reps = cnt[keep]
    return (doc[keep].repeat_interleave(reps),
            wid[keep].repeat_interleave(reps))


def _require(generator, what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} needs a torch.Generator, or the draw "
                         f"injected")
    return generator


def _draw_seed(generator: torch.Generator) -> int:
    """A 64-bit Philox seed drawn from ``generator``."""
    _require(generator, "the Philox seed")
    hi, lo = torch.randint(0, 2 ** 32, (2,), generator=generator,
                           device=generator.device).tolist()
    return (hi << 32) | lo


def gibbs_init(generator: Optional[torch.Generator], doc_ids, word_ids,
               D: int, cfg: LDAConfig, z: Optional[torch.Tensor] = None):
    """Random topic assignment and its counts: (z int32 [T], n_dk [D, K],
    n_wk [W, K], n_k [K]), float32 counts on the tokens' device.  ``z``
    (injected) replaces the draw from ``generator``."""
    K, dev = cfg.num_topics, doc_ids.device
    T = doc_ids.shape[0]
    if z is None:
        z = torch.randint(0, K, (T,), generator=_require(generator, "z"),
                          device=dev, dtype=torch.int32)
    else:
        z = z.to(device=dev, dtype=torch.int32).clone()
    ones = torch.ones(T, dtype=torch.float32, device=dev)
    n_dk = torch.zeros((D, K), dtype=torch.float32, device=dev).index_put_(
        (doc_ids.long(), z.long()), ones, accumulate=True)
    n_wk = torch.zeros((cfg.vocab_size, K), dtype=torch.float32,
                       device=dev).index_put_(
        (word_ids.long(), z.long()), ones, accumulate=True)
    return z, n_dk, n_wk, n_wk.sum(0)


def gibbs_sweep(noise_or_seed, z, n_dk, n_wk, n_k, doc_ids, word_ids,
                cfg: LDAConfig, *, sweep: int = 0, inplace: bool = False):
    """One full sequential sweep over all tokens.  Returns (z, n_dk, n_wk,
    n_k) after it.

    ``noise_or_seed``: a float32 [T, K] Gumbel noise tensor (the injected
    draw), or an int seed of the kernel's Philox noise, keyed with
    ``sweep``.  As the reference, it leaves its inputs untouched and
    returns new tensors; ``inplace=True`` sweeps the given tensors
    themselves (no copy of the [W, K] counts).  The word count uses
    ``W = cfg.vocab_size``, the reference's smoothing mass W * beta.
    """
    if not inplace:
        z, n_dk, n_wk, n_k = (x.clone() for x in (z, n_dk, n_wk, n_k))
    return sweep_kernel(z, n_dk, n_wk, n_k, doc_ids, word_ids,
                        noise_or_seed, alpha=cfg.alpha, beta=cfg.beta,
                        W=cfg.vocab_size, sweep=sweep)


def run_gibbs(generator: Optional[torch.Generator], batch: MiniBatch,
              cfg: LDAConfig, sweeps: int, *,
              z0: Optional[torch.Tensor] = None,
              noise: Optional[Sequence[torch.Tensor]] = None,
              callback=None, device="cuda"):
    """Batch collapsed GS.  Returns (phi_hat [W, K] = n_wk, theta_hat
    [D, K] = n_dk).

    ``generator`` (on ``device``) draws the initial topics and the Philox
    seed; ``z0`` [T] and ``noise`` (one float32 [T, K] tensor a sweep)
    inject those draws instead (``generator`` may then be None).
    ``callback(s, z, n_dk, n_wk, n_k)``, if given, sees the state after
    sweep s.  The chain sweeps its own state in place.
    """
    dev = resolve_device(device)
    batch = MiniBatch(batch.word_ids.to(dev), batch.counts.to(dev))
    doc_ids, word_ids = tokens_from_batch(batch)
    z, n_dk, n_wk, n_k = gibbs_init(generator, doc_ids, word_ids,
                                    batch.num_docs, cfg, z=z0)
    seed = _draw_seed(generator) if noise is None else None
    for s in range(sweeps):
        gibbs_sweep(seed if noise is None else noise[s].to(dev), z, n_dk,
                    n_wk, n_k, doc_ids, word_ids, cfg, sweep=s, inplace=True)
        if callback is not None:
            callback(s, z, n_dk, n_wk, n_k)
    return n_wk, n_dk


def run_parallel_gibbs(generator: Optional[torch.Generator],
                       batches: Sequence[MiniBatch], cfg: LDAConfig,
                       sweeps: int, *,
                       z0: Optional[Sequence[torch.Tensor]] = None,
                       noise=None, device="cuda"):
    """AD-LDA (PGS): shards sweep independently, sync n_wk deltas per sweep.

    ``batches``: one MiniBatch a shard.  Returns (phi_hat, comm_bytes).
    Each shard sweeps a copy of the global counts (one [W, K] copy at a
    time), so the shared ``n_wk`` is untouched until the sweep's deltas are
    summed into it, in shard order.  ``z0`` (one [T_i] tensor a shard) and
    ``noise`` (``noise[s][i]`` the [T_i, K] noise of shard i in sweep s)
    inject the draws; else shard i's sweep s draws the Philox noise of one
    seed from ``generator`` at sweep index ``s * N + i``.
    """
    dev = resolve_device(device)
    shards = []
    for b in batches:
        b = MiniBatch(b.word_ids.to(dev), b.counts.to(dev))
        shards.append((*tokens_from_batch(b), b.num_docs))
    N = len(shards)
    states = []
    n_wk_glob = torch.zeros((cfg.vocab_size, cfg.num_topics),
                            dtype=torch.float32, device=dev)
    for i, (d, w, nd) in enumerate(shards):
        z, n_dk, n_wk, _ = gibbs_init(generator, d, w, nd, cfg,
                                      z=None if z0 is None else z0[i])
        states.append([z, n_dk])
        n_wk_glob = n_wk_glob + n_wk
        del n_wk
    seed = _draw_seed(generator) if noise is None else None
    comm_bytes = 0
    for s in range(sweeps):
        n_k_glob = n_wk_glob.sum(0)
        deltas = torch.zeros_like(n_wk_glob)
        for i, ((d, w, nd), st) in enumerate(zip(shards, states)):
            z, n_dk = st
            draw = seed if noise is None else noise[s][i].to(dev)
            z2, n_dk2, n_wk2, _ = gibbs_sweep(draw, z, n_dk, n_wk_glob,
                                              n_k_glob, d, w, cfg,
                                              sweep=s * N + i)
            # the shard's moves: n_wk2 = n_wk_glob - before + after, exact
            # in float32 integers (the reference's local_after -
            # local_before)
            deltas += n_wk2.sub_(n_wk_glob)
            del n_wk2
            states[i] = [z2, n_dk2]
        n_wk_glob = n_wk_glob + deltas            # Eq. (4) style dense sync
        del deltas
        comm_bytes += n_wk_glob.numel() * 4 * N
    return n_wk_glob, comm_bytes
