"""Synthetic LDA corpora (numpy; a copy of the reference's generators, so
both packages draw the same documents from the same seed).

Each generator returns a list of ``(word_ids, counts)`` numpy pairs, one
per document, plus Table-3-style stats.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Doc = Tuple[np.ndarray, np.ndarray]           # (word_ids[int32], counts[float32])


@dataclasses.dataclass
class CorpusStats:
    num_docs: int
    vocab_size: int
    num_tokens: int
    nnz: int

    def __str__(self) -> str:
        return (f"D={self.num_docs} W={self.vocab_size} "
                f"N_token={self.num_tokens} NNZ={self.nnz}")


def _docs_from_token_lists(token_lists: List[np.ndarray], W: int):
    docs: List[Doc] = []
    n_tok = 0
    nnz = 0
    for toks in token_lists:
        ids, cnt = np.unique(toks, return_counts=True)
        docs.append((ids.astype(np.int32), cnt.astype(np.float32)))
        n_tok += int(toks.size)
        nnz += int(ids.size)
    return docs, CorpusStats(len(docs), W, n_tok, nnz)


def _sample_docs(rng, num_docs: int, phi: np.ndarray, doc_len_mean: int,
                 alpha: float) -> List[np.ndarray]:
    K, W = phi.shape
    token_lists = []
    for _ in range(num_docs):
        n = max(4, int(rng.poisson(doc_len_mean)))
        theta = rng.dirichlet(np.full(K, alpha + 0.05))
        z = rng.choice(K, size=n, p=theta)
        toks = np.empty(n, np.int64)
        for k in np.unique(z):
            idx = np.nonzero(z == k)[0]
            toks[idx] = rng.choice(W, size=idx.size, p=phi[k])
        token_lists.append(toks)
    return token_lists


def lda_corpus(seed: int, num_docs: int, vocab_size: int, num_topics: int,
               doc_len_mean: int = 160, alpha: float = 0.1,
               beta: float = 0.01):
    """Sample a corpus from the smoothed-LDA generative model.

    Returns (docs, stats, true_phi[K, W]).
    """
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(vocab_size, beta + 0.05), size=num_topics)
    token_lists = _sample_docs(rng, num_docs, phi, doc_len_mean, alpha)
    docs, stats = _docs_from_token_lists(token_lists, vocab_size)
    return docs, stats, phi.astype(np.float32)


def lda_corpus_from_phi(seed: int, num_docs: int, phi: np.ndarray,
                        doc_len_mean: int = 160, alpha: float = 0.1):
    """Sample documents from a fixed topic-word matrix phi[K, W]."""
    rng = np.random.default_rng(seed)
    token_lists = _sample_docs(rng, num_docs, phi, doc_len_mean, alpha)
    return _docs_from_token_lists(token_lists, phi.shape[1])
