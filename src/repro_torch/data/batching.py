"""Padded-CSR batching and mini-batch streaming (counterpart of
``repro.data.batching``): truncation, padding, slab refill buffers, the
length-bucket ladder, prefetched mini-batch streams (one of them mapping
external keys through a ``VocabMap``), the token-balanced document split
and the 80/20 held-out split.

Streams are built on the host (numpy, then CPU tensors) on a background
thread, so batch construction overlaps the device's work.  With N data
shards a batch is stacked [N, D/N, L] on a leading shard axis
(`stack_shards`), as the lockstep simulation consumes it.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import MiniBatch
from repro_torch.data.synthetic import Doc


def truncate_doc(ids: np.ndarray, counts: np.ndarray, max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep a document's ``max_len`` highest-count words; no-op for a
    document that already fits."""
    if len(ids) > max_len:
        keep = np.argsort(-counts)[:max_len]
        return ids[keep], counts[keep]
    return ids, counts


def docs_to_padded(docs: Sequence[Doc], max_len: int | None = None,
                   pad_multiple: int = 8) -> MiniBatch:
    """Pack (word_ids, counts) documents into a padded MiniBatch of CPU
    tensors, L padded up to a multiple of ``pad_multiple``; documents
    longer than ``max_len`` are truncated by `truncate_doc`."""
    if max_len is None:
        max_len = max((len(d[0]) for d in docs), default=1)
    max_len = max(1, -(-max_len // pad_multiple) * pad_multiple)
    D = len(docs)
    wid = np.zeros((D, max_len), np.int32)
    cnt = np.zeros((D, max_len), np.float32)
    for i, (ids, counts) in enumerate(docs):
        ids, counts = truncate_doc(ids, counts, max_len)
        wid[i, : len(ids)] = ids
        cnt[i, : len(ids)] = counts
    return MiniBatch(word_ids=torch.from_numpy(wid),
                     counts=torch.from_numpy(cnt))


def slab_refill(docs: Sequence[Doc], slot_ids: Sequence[int], *,
                capacity: int, slot_len: int, pad_slot: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack pending documents into [capacity, slot_len] slab refill
    buffers (the host half of ``core.infer.make_slab_step``).

    Lays up to ``min(len(docs), len(slot_ids), capacity)`` documents into
    the first rows, truncating over-long ones; unused lanes carry
    ``pad_slot`` (the slab's slot count) as their slot index.  Returns
    ``(word_rows int32, counts float32, slots int32 [capacity], taken)``.
    """
    n = min(len(docs), len(slot_ids), capacity)
    wid = np.zeros((capacity, slot_len), np.int32)
    cnt = np.zeros((capacity, slot_len), np.float32)
    slot = np.full((capacity,), int(pad_slot), np.int32)
    for i in range(n):
        ids, counts = truncate_doc(np.asarray(docs[i][0]),
                                   np.asarray(docs[i][1], np.float32),
                                   slot_len)
        wid[i, : len(ids)] = ids
        cnt[i, : len(ids)] = counts
        slot[i] = int(slot_ids[i])
    return wid, cnt, slot, n


def make_len_buckets(max_len: int, min_len: int = 8, growth: float = 2.0,
                     pad_multiple: int = 8) -> Tuple[int, ...]:
    """Geometric ladder of L buckets covering [1, max_len], each a
    multiple of ``pad_multiple``."""
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    buckets: List[int] = []
    b = float(max(min_len, 1))
    while True:
        bb = int(-(-int(round(b)) // pad_multiple) * pad_multiple)
        if not buckets or bb > buckets[-1]:
            buckets.append(bb)
        if bb >= max_len:
            return tuple(buckets)
        b *= growth


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket when n exceeds them all."""
    for b in buckets:
        if b >= n:
            return int(b)
    return int(buckets[-1])


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

_SENTINEL = object()


def _put_until_stopped(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Bounded put that polls ``stop`` instead of blocking forever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def prefetched(gen_factory: Callable[[], Iterator], prefetch: int) -> Iterator:
    """Run ``gen_factory()`` on a background thread with a bounded queue.

    Abandoning the returned generator stops and joins the thread (its puts
    poll a stop event); an exception in the worker is raised again in the
    consumer.  ``prefetch <= 0`` runs the generator inline.
    """
    if prefetch <= 0:
        yield from gen_factory()
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    err: List[BaseException] = []

    def worker():
        try:
            for item in gen_factory():
                if not _put_until_stopped(q, item, stop):
                    return
        except BaseException as e:  # noqa: BLE001 (raised in the consumer)
            err.append(e)
        finally:
            _put_until_stopped(q, _SENTINEL, stop)

    t = threading.Thread(target=worker, daemon=True,
                         name="repro-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        t.join(timeout=10.0)
        if t.is_alive():
            warnings.warn("prefetch worker failed to stop within 10s of "
                          "shutdown and was leaked", RuntimeWarning,
                          stacklevel=2)


def stack_shards(mb: MiniBatch, num_shards: int) -> MiniBatch:
    """[D, L] -> [N, D/N, L]: the leading shard axis of the lockstep
    simulation (a view); N = 1 returns the batch as it is."""
    if num_shards <= 1:
        return mb
    D, L = mb.word_ids.shape
    if D % num_shards:
        raise ValueError(f"batch of {D} docs does not divide over "
                         f"{num_shards} shards")
    shape = (num_shards, D // num_shards, L)
    return MiniBatch(word_ids=mb.word_ids.reshape(shape),
                     counts=mb.counts.reshape(shape))


def _padded_chunk(docs: Sequence[Doc], m: int, batch_docs: int,
                  multiple: int) -> List[Doc]:
    """Documents of batch ``m``, padded with empty documents up to a
    multiple of ``multiple``."""
    chunk = list(docs[m * batch_docs: (m + 1) * batch_docs])
    if multiple > 1 and len(chunk) % multiple:
        chunk += [(np.zeros(1, np.int32), np.zeros(1, np.float32))
                  ] * (multiple - len(chunk) % multiple)
    return chunk


def minibatch_stream(docs: Sequence[Doc], batch_docs: int,
                     max_len: int | None = None, prefetch: int = 2,
                     pad_docs_multiple: int = 1) -> Iterator[MiniBatch]:
    """Yield MiniBatches of ``batch_docs`` documents (the last one may be
    shorter, padded with empty documents to a multiple of
    ``pad_docs_multiple`` so it divides over the shards), built on a
    prefetch thread."""
    n_batches = -(-len(docs) // batch_docs)

    def slices():
        for m in range(n_batches):
            yield docs_to_padded(_padded_chunk(docs, m, batch_docs,
                                               pad_docs_multiple), max_len)

    yield from prefetched(slices, prefetch)


def sharded_minibatch_stream(docs: Sequence[Doc], batch_docs: int,
                             num_shards: int, max_len: int | None = None,
                             prefetch: int = 2) -> Iterator[MiniBatch]:
    """Yield MiniBatches stacked [N, Dl, L] on a leading shard axis, Dl =
    ceil(batch_docs / N)."""
    per_shard = -(-batch_docs // num_shards)
    for mb in minibatch_stream(docs, per_shard * num_shards, max_len,
                               prefetch, pad_docs_multiple=num_shards):
        yield stack_shards(mb, num_shards)


def bucketed_minibatch_stream(docs: Sequence[Doc], batch_docs: int,
                              num_shards: int = 1,
                              len_buckets: Sequence[int] = (16, 32, 64, 128),
                              prefetch: int = 2) -> Iterator[MiniBatch]:
    """Shape-bucketed stream: every batch has exactly ``batch_docs``
    documents (a short last chunk is padded with empty documents) and an L
    snapped up to one of ``len_buckets`` (multiples of 8); stacked [N, Dl,
    L] when ``num_shards > 1``."""
    len_buckets = tuple(sorted(int(b) for b in len_buckets))
    if any(b % 8 for b in len_buckets):
        raise ValueError(f"len_buckets must be multiples of 8: {len_buckets}")
    if batch_docs % max(num_shards, 1):
        raise ValueError(f"batch_docs={batch_docs} must divide over "
                         f"num_shards={num_shards}")
    n_batches = -(-len(docs) // batch_docs)

    def slices():
        for m in range(n_batches):
            chunk = _padded_chunk(docs, m, batch_docs, batch_docs)
            nat = max(len(ids) for ids, _ in chunk)
            yield stack_shards(docs_to_padded(
                chunk, max_len=bucket_len(nat, len_buckets)), num_shards)

    yield from prefetched(slices, prefetch)


def shard_docs(docs: Sequence[Doc], num_shards: int) -> List[List[Doc]]:
    """Spread documents over shards by tokens, greedily (paper §4: 'evenly
    distribute D documents to N processors'): the reference's order and
    ties, so both packages split alike."""
    shards: List[List[Doc]] = [[] for _ in range(num_shards)]
    order = np.argsort([-float(c.sum()) for _, c in docs])
    loads = np.zeros(num_shards)
    for i in order:
        j = int(np.argmin(loads))
        shards[j].append(docs[i])
        loads[j] += float(docs[i][1].sum())
    return shards


def vocab_mapped_minibatch_stream(docs: Sequence[Doc], vocab,
                                  batch_docs: int, num_shards: int = 1,
                                  len_buckets: Sequence[int] = (16, 32, 64,
                                                                128),
                                  prefetch: int = 2, admit: bool = True,
                                  oov_row: int | None = None
                                  ) -> Iterator[Tuple[MiniBatch, int]]:
    """Shape-bucketed stream over external-id documents: each chunk's keys
    go through ``vocab`` (a ``data.vocab.VocabMap``) before padding, and
    each batch comes with the live vocabulary size right after its
    admissions, taken in generation order on the prefetch thread (so it
    does not depend on how far the prefetch runs ahead).  Yields
    ``(MiniBatch, live_w)``, stacked [N, Dl, L] when ``num_shards > 1``.
    The driver's ``launch.lda_train.drifting_stream`` applies the same
    map, snapshot, bucket and pad to batches it draws lazily."""
    len_buckets = tuple(sorted(int(b) for b in len_buckets))
    if any(b % 8 for b in len_buckets):
        raise ValueError(f"len_buckets must be multiples of 8: {len_buckets}")
    if batch_docs % max(num_shards, 1):
        raise ValueError(f"batch_docs={batch_docs} must divide over "
                         f"num_shards={num_shards}")
    n_batches = -(-len(docs) // batch_docs)

    def slices():
        for m in range(n_batches):
            chunk = vocab.map_docs(docs[m * batch_docs: (m + 1) * batch_docs],
                                   admit=admit, oov_row=oov_row)
            live = vocab.live
            nat = max((len(ids) for ids, _ in chunk), default=1)
            if len(chunk) < batch_docs:
                chunk += [(np.zeros(1, np.int32), np.zeros(1, np.float32))
                          ] * (batch_docs - len(chunk))
            mb = docs_to_padded(chunk, max_len=bucket_len(nat, len_buckets))
            yield stack_shards(mb, num_shards), live

    yield from prefetched(slices, prefetch)


def train_test_split_counts(docs: Sequence[Doc], seed: int,
                            test_frac: float = 0.2
                            ) -> Tuple[List[Doc], List[Doc]]:
    """Per-document 80/20 split of each document's token multiset for
    predictive perplexity (paper §4, Eq. 20): (train_docs, test_docs),
    aligned by position.  The same numpy draws as the reference."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for ids, counts in docs:
        tr = np.zeros_like(counts)
        te = np.zeros_like(counts)
        for j, c in enumerate(counts):
            k = rng.binomial(int(c), test_frac)
            te[j] = k
            tr[j] = c - k
        keep_tr = tr > 0
        keep_te = te > 0
        train.append((ids[keep_tr], tr[keep_tr].astype(np.float32)))
        test.append((ids[keep_te], te[keep_te].astype(np.float32)))
    return train, test
