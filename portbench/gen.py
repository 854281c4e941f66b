"""Inputs made on the device from the seed: a topic model and documents
drawn from the LDA generative model.

Everything here runs in a few large calls on the device that holds the
generator (a loop over blocks of documents at most, never over topics or
words), so set-up stays short at PUBMED width.

  - `make_model`: topics phi_true [K, W] ~ Dirichlet(conc * W * zipf),
    with zipf the Zipf(s) law over word rank (word 0 the most frequent),
    so word frequencies follow the power law the power-word selection
    exists for; and the trained statistic phi_acc [W, K] = phi_true.T *
    scale, a model that keeps streaming.
  - `doc_lengths`: a fixed set of log-normal lengths (the quantiles of the
    law at (i + 0.5) / n), permuted by the generator, so every seed draws
    the same multiset of lengths and only their order changes.
  - `make_docs`: theta_d ~ Dirichlet(theta_conc), z ~ theta_d, words ~
    phi_true[z] by one multinomial call over all topics; then each
    document's distinct words and counts, found on the device by sorting
    (document, word) keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Docs(NamedTuple):
    """Documents as flat (word, count) pairs grouped by document: the
    pairs of document d are ``[offsets[d], offsets[d + 1])``, words
    ascending within a document."""

    words: torch.Tensor        # int64 [N]
    counts: torch.Tensor       # float32 [N]
    offsets: torch.Tensor      # int64 [D + 1]


def zipf_base(W: int, s: float, device) -> torch.Tensor:
    """The Zipf(s) law over ranks 1..W, float64, summing to 1."""
    r = torch.arange(1, W + 1, dtype=torch.float64, device=device)
    p = r.pow(-float(s))
    return p / p.sum()


def make_model(gen: torch.Generator, W: int, K: int, *, conc: float,
               zipf: float, scale: float, block_topics: int = 1024):
    """(phi_true [K, W], phi_acc [W, K]), float32 on ``gen``'s device.

    The gamma draws run over blocks of ``block_topics`` topics, so the
    expanded concentration never takes more than a block's memory."""
    dev = gen.device
    a = (zipf_base(W, zipf, dev) * (conc * W)).to(torch.float32)
    phi_true = torch.empty((K, W), dtype=torch.float32, device=dev)
    for k0 in range(0, K, block_topics):
        k1 = min(K, k0 + block_topics)
        phi_true[k0:k1] = torch._standard_gamma(
            a.expand(k1 - k0, W).contiguous(), generator=gen)
    phi_true /= phi_true.sum(dim=1, keepdim=True)
    phi_acc = phi_true.T.contiguous()
    phi_acc *= scale
    return phi_true, phi_acc


def doc_lengths(gen: torch.Generator, n: int, *, mean: float, sigma: float,
                minimum: int) -> torch.Tensor:
    """``n`` document lengths (tokens), int64: the log-normal law with this
    mean and sigma at the quantiles (i + 0.5) / n, rounded, at least
    ``minimum``, in an order drawn from ``gen``."""
    dev = gen.device
    mu = math.log(mean) - sigma * sigma / 2
    q = (torch.arange(n, dtype=torch.float64, device=dev) + 0.5) / n
    z = math.sqrt(2.0) * torch.erfinv(2 * q - 1)
    lens = torch.exp(mu + sigma * z).round().clamp_min(minimum).long()
    return lens[torch.randperm(n, generator=gen, device=dev)]


def make_docs(gen: torch.Generator, phi_true: torch.Tensor,
              lengths: torch.Tensor, *, theta_conc: float,
              block_docs: int = 16384) -> Docs:
    """Documents of the given lengths from the LDA generative model over
    ``phi_true`` [K, W], on its device."""
    K, W = phi_true.shape
    dev = phi_true.device
    n = lengths.shape[0]
    # topics of every token, a block of documents at a time
    z_parts = []
    for d0 in range(0, n, block_docs):
        lens = lengths[d0:d0 + block_docs]
        theta = torch._standard_gamma(
            torch.full((lens.shape[0], K), float(theta_conc),
                       device=dev), generator=gen)
        theta /= theta.sum(dim=1, keepdim=True).clamp_min(1e-30)
        z = torch.multinomial(theta, int(lens.max()), replacement=True,
                              generator=gen)
        keep = torch.arange(z.shape[1], device=dev)[None, :] < lens[:, None]
        z_parts.append(z[keep])
        del theta, z, keep
    zk = torch.cat(z_parts)
    del z_parts
    # the words: the j-th token of topic k takes topic k's j-th draw
    per_topic = torch.bincount(zk, minlength=K)
    draws = torch.multinomial(phi_true, int(per_topic.max()),
                              replacement=True, generator=gen)
    order = torch.argsort(zk, stable=True)
    starts = torch.cumsum(per_topic, 0) - per_topic
    zs = zk[order]
    rank = torch.arange(zs.shape[0], device=dev) - starts[zs]
    words = torch.empty_like(zk)
    words[order] = draws[zs, rank]
    del draws, order, zs, rank
    # distinct words and their counts, a document at a time by key
    doc = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    keys, counts = torch.unique(doc * W + words, sorted=True,
                                return_counts=True)
    pairs = torch.bincount(keys // W, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(pairs, 0)
    return Docs(words=keys % W, counts=counts.to(torch.float32),
                offsets=offsets)


def padded(docs: Docs, first: int, count: int, L: int):
    """Documents ``[first, first + count)`` as a padded [count, L] batch
    (word ids int32, counts float32) on their device; a document with more
    than ``L`` distinct words keeps its ``L`` highest-count words (ties to
    the lower word id).  Padding slots carry word 0 and count 0."""
    dev = docs.words.device
    lo = docs.offsets[first:first + count]
    hi = docs.offsets[first + 1:first + count + 1]
    n = hi - lo
    doc = torch.repeat_interleave(torch.arange(count, device=dev), n)
    idx = torch.arange(int(hi[-1] - lo[0]), device=dev) + lo[0]
    w, c = docs.words[idx], docs.counts[idx]
    # within a document: by count descending, then word ascending
    key = (doc * (1 << 20) - c.long()) * (1 << 20) + w
    o = torch.argsort(key)
    doc, w, c = doc[o], w[o], c[o]
    pos = torch.arange(doc.shape[0], device=dev) - (torch.cumsum(n, 0)
                                                    - n)[doc]
    keep = pos < L
    wid = torch.zeros((count, L), dtype=torch.int32, device=dev)
    cnt = torch.zeros((count, L), dtype=torch.float32, device=dev)
    wid[doc[keep], pos[keep]] = w[keep].to(torch.int32)
    cnt[doc[keep], pos[keep]] = c[keep]
    return wid, cnt
