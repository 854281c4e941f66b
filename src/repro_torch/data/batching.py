"""Padded-CSR batching for serving (counterpart of the serving half of
``repro.data.batching``): truncation, padding, slab refill buffers and
the length-bucket ladder."""

from __future__ import annotations

from typing import List, Sequence, Tuple

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
