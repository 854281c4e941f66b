"""Synthetic LDA corpora (numpy; a copy of the reference's generators, so
both packages draw the same documents from the same seed).

Each generator returns a list of ``(word_ids, counts)`` numpy pairs, one
per document, plus Table-3-style stats.  The two drifting streams
(``drifting_vocab_docs``, a growing vocabulary, and
``drifting_news_stream``, a sliding one) return external word ids, to be
mapped to phi rows through ``data.vocab.VocabMap``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Tuple

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


def topic_cdf(phi: np.ndarray) -> np.ndarray:
    """Each topic's cumulative word distribution [K, W] as numpy's weighted
    ``Generator.choice(W, p=phi[k])`` forms it (float64, a running sum
    divided by its last entry).  Given it, `_sample_docs` draws a word with
    one uniform and a binary search, the numbers ``choice`` draws, without
    its O(W) pass per call: at PUBMED width (W = 141,043) 0.007 ms a draw
    against 2.9 ms."""
    cdf = phi.astype(np.float64).cumsum(axis=1)
    cdf /= cdf[:, -1:]
    return cdf


def _token_lists(rng, num_docs: int, K: int, doc_len_mean: int,
                 alpha: float, words: Callable) -> List[np.ndarray]:
    """The reference's document loop: a length, a topic mixture, each
    token's topic, then ``words(k, n)``, n word ids of topic k."""
    token_lists = []
    for _ in range(num_docs):
        n = max(4, int(rng.poisson(doc_len_mean)))
        theta = rng.dirichlet(np.full(K, alpha + 0.05))
        z = rng.choice(K, size=n, p=theta)
        toks = np.empty(n, np.int64)
        for k in np.unique(z):
            idx = np.nonzero(z == k)[0]
            toks[idx] = words(k, idx.size)
        token_lists.append(toks)
    return token_lists


def _cdf_words(rng, cdf: np.ndarray, offset: int = 0) -> Callable:
    """``words(k, n)`` drawing from the rows of a `topic_cdf`: one uniform
    and a binary search a word, the numbers ``rng.choice(W, p=...)``
    draws."""
    return lambda k, n: offset + cdf[k].searchsorted(rng.random(n),
                                                     side="right")


def _sample_docs(rng, num_docs: int, phi: np.ndarray, doc_len_mean: int,
                 alpha: float, cdf=None) -> List[np.ndarray]:
    K, W = phi.shape
    words = (_cdf_words(rng, cdf) if cdf is not None else
             lambda k, n: rng.choice(W, size=n, p=phi[k]))
    return _token_lists(rng, num_docs, K, doc_len_mean, alpha, words)


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
                        doc_len_mean: int = 160, alpha: float = 0.1,
                        cdf: np.ndarray = None):
    """Sample documents from a fixed topic-word matrix phi[K, W]; ``cdf``
    (`topic_cdf` of phi, made once for many calls) draws the same documents
    faster."""
    rng = np.random.default_rng(seed)
    token_lists = _sample_docs(rng, num_docs, phi, doc_len_mean, alpha, cdf)
    return _docs_from_token_lists(token_lists, phi.shape[1])


def zipf_corpus(seed: int, num_docs: int, vocab_size: int,
                doc_len_mean: int = 160, zipf_s: float = 1.07):
    """Zipf word marginals (power-law, the regime of Fig. 6).  Returns
    (docs, stats)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-zipf_s)
    p /= p.sum()
    token_lists = []
    for _ in range(num_docs):
        n = max(4, int(rng.poisson(doc_len_mean)))
        token_lists.append(rng.choice(vocab_size, size=n, p=p))
    return _docs_from_token_lists(token_lists, vocab_size)


# ------------------------------------------------------------ drifting streams

# new words past which the per-word scores are drawn in worker processes,
# and the words a worker draws at a time (each word has a generator of its
# own, so the split changes no number)
_PARALLEL_WORDS = 32768
_SCORE_CHUNK = 8192


def _word_scores(seed: int, num_topics: int, lo: int, hi: int) -> np.ndarray:
    """The reference's counter-based topic scores of words [lo, hi): one
    generator a (seed, word), gamma(0.5) per topic.  float64 [hi - lo, K]."""
    return np.stack([
        np.random.default_rng([seed, 104_729, w]).gamma(0.5, size=num_topics)
        for w in range(lo, hi)])


def _score_worker() -> None:
    """Entry of a worker process: ``_word_scores(*argv)`` as raw float64
    bytes on stdout."""
    seed, num_topics, lo, hi = (int(a) for a in sys.argv[1:5])
    sys.stdout.buffer.write(_word_scores(seed, num_topics, lo, hi).tobytes())


def _scores_in_processes(seed: int, num_topics: int, lo: int, hi: int,
                         workers: int) -> np.ndarray:
    """`_word_scores` of [lo, hi) in chunks, each drawn by a fresh Python
    process (up to ``workers`` at once) that imports this module alone and
    writes its rows to a pipe; every process has ended on return."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    code = ("from repro_torch.data.synthetic import _score_worker; "
            "_score_worker()")

    def chunk(a: int) -> np.ndarray:
        b = min(a + _SCORE_CHUNK, hi)
        out = subprocess.run(
            [sys.executable, "-c", code, str(seed), str(num_topics), str(a),
             str(b)], env=env, capture_output=True, check=True).stdout
        return np.frombuffer(out, np.float64).reshape(b - a, num_topics)

    with ThreadPoolExecutor(workers) as ex:
        return np.vstack(list(ex.map(chunk, range(lo, hi, _SCORE_CHUNK))))


def _scores_upto(cache: dict, seed: int, num_topics: int, hi: int
                 ) -> np.ndarray:
    """``cache["scores"]`` extended to the first ``hi`` words.  A large
    extension is drawn in up to 8 worker processes (at PUBMED width,
    141,043 x 2000 gamma draws take ~30 s on one core)."""
    scores = cache.get("scores")
    have = 0 if scores is None else scores.shape[0]
    if have >= hi:
        return scores
    workers = min(8, len(os.sched_getaffinity(0)))
    if hi - have >= _PARALLEL_WORDS and workers > 1:
        new = _scores_in_processes(seed, num_topics, have, hi, workers)
    else:
        new = _word_scores(seed, num_topics, have, hi)
    scores = new if scores is None else np.vstack([scores, new])
    cache["scores"] = scores
    return scores


def _window_cdf(cache: dict, scores: np.ndarray, lo: int, hi: int
                ) -> np.ndarray:
    """`topic_cdf` of the reference's per-topic word distribution over the
    window [lo, hi): ``p_wk = act / act.sum(axis=0)`` with ``act =
    scores[lo:hi] + 1e-6``, formed topic-major [K, hi - lo] (the same
    divisions, so the same numbers) and cumulated in place as
    ``rng.choice`` cumulates ``p_wk[:, k]``.  The last window's cdf is kept
    in ``cache``: a held-out draw from the window a batch trained on takes
    it again."""
    got = cache.get("cdf")
    if got is not None and got[:2] == (lo, hi) and \
            got[2].shape[0] == scores.shape[1]:
        return got[2]
    cache.pop("cdf", None)
    act = scores[lo:hi] + 1e-6                          # [window, K]
    tot = act.sum(axis=0, keepdims=True)
    cdf = np.ascontiguousarray(act.T)
    del act
    cdf /= tot.T
    np.cumsum(cdf, axis=1, out=cdf)
    cdf /= cdf[:, -1:]
    cache["cdf"] = (lo, hi, cdf)
    return cdf


def drifting_vocab_docs(seed: int, m: int, num_docs: int, active_vocab: int,
                        num_topics: int, doc_len_mean: int = 40,
                        alpha: float = 0.1, score_cache: dict | None = None):
    """Batch ``m`` of the growing-vocabulary stream, as the reference draws
    it: documents over the first ``active_vocab`` external word ids, each
    word's topic scores counter-based (a generator a (seed, word)), so a
    longer prefix never changes an earlier word and batch m is a pure
    function of (seed, m, active_vocab).  ``score_cache`` (a dict) keeps
    the scores (and the last window's cdf) across calls.  Returns (docs
    with EXTERNAL word ids, stats)."""
    cache = score_cache if score_cache is not None else {}
    scores = _scores_upto(cache, seed, num_topics, active_vocab)
    cdf = _window_cdf(cache, scores, 0, active_vocab)
    rng = np.random.default_rng([seed, 7, m])
    token_lists = _token_lists(rng, num_docs, num_topics, doc_len_mean,
                               alpha, _cdf_words(rng, cdf))
    return _docs_from_token_lists(token_lists, active_vocab)


def drifting_news_stream(seed: int, m: int, num_docs: int, vocab_window: int,
                         drift_per_batch: int, num_topics: int,
                         doc_len_mean: int = 40, alpha: float = 0.1,
                         score_cache: dict | None = None,
                         heldout: bool = False):
    """Batch ``m`` of the sliding-vocabulary stream, as the reference draws
    it: documents over the external ids ``[drift_per_batch * m,
    drift_per_batch * m + vocab_window)``, so each batch retires as many
    words as it brings in; the scores are `drifting_vocab_docs`'s.
    ``heldout=True`` draws an independent document set from the same
    window (a disjoint generator): the held-out set that moves with the
    stream.  Returns (docs with EXTERNAL word ids, stats)."""
    lo = drift_per_batch * m
    hi = lo + vocab_window
    cache = score_cache if score_cache is not None else {}
    scores = _scores_upto(cache, seed, num_topics, hi)
    cdf = _window_cdf(cache, scores, lo, hi)
    rng = np.random.default_rng([seed, 11 if heldout else 7, m])
    token_lists = _token_lists(rng, num_docs, num_topics, doc_len_mean,
                               alpha, _cdf_words(rng, cdf, lo))
    return _docs_from_token_lists(token_lists, vocab_window)
