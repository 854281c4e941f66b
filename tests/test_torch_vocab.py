"""The port's dynamic-vocabulary data plumbing held against the JAX
package's numpy modules: ``VocabMap`` (admission, touch stamps,
compaction, the manifest round trip) and ``next_capacity``, the two
drifting streams, the vocabulary-mapped mini-batch stream and the
token-balanced document split; and serving, which must never admit.

Every comparison is exact: both packages run the same numpy code on the
same seeds, so rows, remaps, stamps and documents must be equal bit for
bit."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data import batching as jbatch
from repro.data import synthetic as jsyn
from repro.data import vocab as jvocab
from repro_torch.core.types import LDAConfig
from repro_torch.data import batching, synthetic
from repro_torch.data.vocab import VocabMap, next_capacity


def _key_batches(seed, n_batches=5, per_batch=40, universe=90):
    """Batches of string keys drawn with repeats from a fixed universe."""
    rng = np.random.default_rng(seed)
    return [[f"w{int(k)}" for k in rng.integers(0, universe, per_batch)]
            for _ in range(n_batches)]


def _same_docs(got, want):
    (gd, gs), (wd, ws) = got, want
    assert dataclasses.astuple(gs) == dataclasses.astuple(ws)
    assert len(gd) == len(wd)
    for (gi, gc), (wi, wc) in zip(gd, wd):
        assert gi.dtype == wi.dtype and gc.dtype == wc.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vocab_map_admits_stamps_and_compacts_as_the_reference(seed):
    """The same key sequences through both maps: the rows (admitted with a
    step, and looked up without admitting), ``keys_upto``,
    ``touched_upto``, a compaction's remap and the state after it, and the
    (keys, touched) manifest round trip."""
    mine, theirs = VocabMap(), jvocab.VocabMap()
    rng = np.random.default_rng(seed + 10)
    for m, keys in enumerate(_key_batches(seed)):
        step = m if m != 2 else None              # one batch without a stamp
        np.testing.assert_array_equal(mine.rows(keys, step=step),
                                      theirs.rows(keys, step=step))
        probe = keys[:5] + ["never-seen"]
        np.testing.assert_array_equal(
            mine.rows(probe, admit=False, oov_row=mine.live),
            theirs.rows(probe, admit=False, oov_row=theirs.live))
        assert mine.live == theirs.live == len(mine)
        n = int(rng.integers(0, mine.live + 1))
        assert mine.keys_upto(n) == theirs.keys_upto(n)
        assert mine.touched_upto(n) == theirs.touched_upto(n)
    keep = rng.random(mine.live - 3) > 0.35        # the last 3 rows kept
    remap = mine.compact(keep)
    want = theirs.compact(keep)
    assert remap.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(remap, want)
    assert mine.to_state() == theirs.to_state()
    assert mine.touched_upto(mine.live) == theirs.touched_upto(theirs.live)
    # freed rows are reused first, as the reference reuses them
    assert mine.admit("fresh", step=9) == theirs.admit("fresh", step=9)
    again = VocabMap.from_state(mine.to_state(),
                                touched=mine.touched_upto(mine.live))
    ref = jvocab.VocabMap.from_state(theirs.to_state(),
                                     touched=theirs.touched_upto(theirs.live))
    assert again.to_state() == ref.to_state()
    assert again.touched_upto(again.live) == ref.touched_upto(ref.live)
    assert again.lookup("fresh") == ref.lookup("fresh")


def test_vocab_map_refusals_match_the_reference():
    for cls in (VocabMap, jvocab.VocabMap):
        with pytest.raises(ValueError, match="unique"):
            cls(["a", "a"])
        with pytest.raises(ValueError, match="touched covers"):
            cls(["a"], touched=[0, 1])
        with pytest.raises(ValueError, match="oov_row"):
            cls(["a"]).rows(["b"], admit=False)
    docs = [(np.asarray([3, 1, 3]), np.asarray([1.0, 2.0, 1.0], np.float32))]
    mine, theirs = VocabMap(), jvocab.VocabMap()
    for (gi, gc), (wi, wc) in zip(mine.map_docs(docs, step=4),
                                  theirs.map_docs(docs, step=4)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
    assert mine.touched_upto(2) == theirs.touched_upto(2) == [4, 4]


@pytest.mark.parametrize("live,cur,min_cap,growth", [
    (0, 0, 64, 2.0), (63, 0, 64, 2.0), (64, 0, 64, 2.0), (91, 64, 64, 2.0),
    (52_000, 64, 64, 2.0), (85_000, 65_536, 64, 2.0), (5, 0, 3, 1.5),
    (1000, 0, 100, 1.01), (141_043, 131_072, 64, 2.0)])
def test_next_capacity_walks_the_reference_ladder(live, cur, min_cap, growth):
    got = next_capacity(live, cur, min_cap, growth)
    assert got == jvocab.next_capacity(live, cur, min_cap, growth)
    assert got > live and got % 8 == 0


def test_next_capacity_refuses_a_flat_ladder():
    with pytest.raises(ValueError, match="growth"):
        next_capacity(10, growth=1.0)


@pytest.mark.parametrize("m", [0, 1, 3])
def test_drifting_vocab_docs_equal_the_reference(m):
    cache = {}
    for active in (120 + 24 * m, 120 + 24 * (m + 1)):     # a longer prefix
        _same_docs(synthetic.drifting_vocab_docs(3, m, 24, active, 12,
                                                 doc_len_mean=30,
                                                 score_cache=cache),
                   jsyn.drifting_vocab_docs(3, m, 24, active, 12,
                                            doc_len_mean=30))
    assert cache["scores"].shape == (120 + 24 * (m + 1), 12)


@pytest.mark.parametrize("heldout", [False, True])
@pytest.mark.parametrize("m", [0, 2, 5])
def test_drifting_news_stream_equals_the_reference(m, heldout):
    cache = {}
    got = synthetic.drifting_news_stream(1, m, 20, 96, 6, 16,
                                         score_cache=cache, heldout=heldout)
    _same_docs(got, jsyn.drifting_news_stream(1, m, 20, 96, 6, 16,
                                              heldout=heldout))
    lo = 6 * m
    for ids, _ in got[0]:
        assert ids.min() >= lo and ids.max() < lo + 96
    # the cached window cdf is taken again, with the same documents
    assert cache["cdf"][:2] == (lo, lo + 96)
    _same_docs(synthetic.drifting_news_stream(1, m, 20, 96, 6, 16,
                                              score_cache=cache,
                                              heldout=heldout), got)


def test_word_scores_drawn_in_worker_processes_are_the_same(monkeypatch):
    """Past ``_PARALLEL_WORDS`` new words the scores are drawn in worker
    processes, in chunks: the same numbers as one serial draw."""
    monkeypatch.setattr(synthetic, "_PARALLEL_WORDS", 100)
    monkeypatch.setattr(synthetic, "_SCORE_CHUNK", 70)
    monkeypatch.setattr(synthetic.os, "sched_getaffinity",
                        lambda _: set(range(2)))
    cache = {}
    got = synthetic._scores_upto(cache, 4, 9, 230)
    np.testing.assert_array_equal(got, synthetic._word_scores(4, 9, 0, 230))
    np.testing.assert_array_equal(
        got, np.stack([np.random.default_rng([4, 104_729, w]).gamma(
            0.5, size=9) for w in range(230)]))
    assert synthetic._scores_upto(cache, 4, 9, 100) is got


def test_vocab_mapped_stream_yields_the_reference_snapshots():
    docs, _ = jsyn.drifting_vocab_docs(2, 0, 40, 150, 8, doc_len_mean=25)
    mine, theirs = VocabMap(), jvocab.VocabMap()
    got = list(batching.vocab_mapped_minibatch_stream(
        docs, mine, 12, num_shards=2, len_buckets=(16, 32), prefetch=2))
    want = list(jbatch.vocab_mapped_minibatch_stream(
        docs, theirs, 12, num_shards=2, len_buckets=(16, 32), prefetch=0))
    assert [live for _, live in got] == [live for _, live in want]
    assert got[-1][1] == mine.live == theirs.live
    for (mb, _), (jmb, _) in zip(got, want):
        assert mb.word_ids.shape == jmb.word_ids.shape
        np.testing.assert_array_equal(mb.word_ids.numpy(), jmb.word_ids)
        np.testing.assert_array_equal(mb.counts.numpy(), jmb.counts)
    # a lookup-only pass maps unseen keys to the OOV row and admits nothing
    before = mine.live
    oov = [(np.asarray([10_000, 1]), np.asarray([2.0, 1.0], np.float32))]
    (mb, live), = batching.vocab_mapped_minibatch_stream(
        oov, mine, 2, len_buckets=(8,), prefetch=0, admit=False,
        oov_row=before)
    assert live == mine.live == before
    assert int(mb.word_ids[0, 0]) == before


def test_shard_docs_splits_as_the_reference():
    docs, _ = jsyn.drifting_news_stream(0, 1, 30, 64, 4, 8)
    got = batching.shard_docs(docs, 4)
    want = jbatch.shard_docs(docs, 4)
    assert [len(s) for s in got] == [len(s) for s in want]
    for g, w in zip(got, want):
        for (gi, gc), (wi, wc) in zip(g, w):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("engine", ["slab", "fold_in"])
def test_serving_unseen_keys_leaves_the_vocabulary_unchanged(engine):
    """Serving looks keys up without admitting them (``admit=False``): a
    request of unseen keys folds in through the guard row, counts as OOV
    mass, and the vocabulary keeps its size and rows."""
    from repro_torch.serve import FoldInEngine, SlabEngine

    W_live, W_cap, K = 40, 48, 6
    rng = np.random.default_rng(0)
    phi = np.zeros((W_cap, K), np.float32)
    phi[:W_live] = rng.gamma(1.0, size=(W_live, K)) * 20
    keys = [f"k{i}" for i in range(W_live)]
    vocab = VocabMap(keys)
    cfg = LDAConfig(vocab_size=W_cap, num_topics=K)
    if engine == "slab":
        eng = SlabEngine(phi, cfg, slots=4, slot_len=8, live_words=W_live,
                         vocab=vocab, device="cpu", warmup=False)
    else:
        eng = FoldInEngine(phi, cfg, len_buckets=(8,), live_words=W_live,
                           vocab=vocab, device="cpu", warmup=False)
    docs = [(np.asarray(["k3", "new-a", "k7"]), np.asarray([2.0, 1.0, 1.0])),
            (np.asarray(["new-b", "new-c"]), np.asarray([1.0, 3.0]))]
    for d in docs:
        eng.submit(d)
    results = eng.drain()
    assert len(vocab) == vocab.live == W_live
    assert vocab.to_state() == keys
    assert vocab.lookup("new-a") is None
    thetas = [torch.as_tensor(r.theta) for r in results]
    assert len(thetas) == 2
    for th in thetas:
        assert torch.isfinite(th).all()
        assert float(th.sum()) == pytest.approx(1.0, abs=1e-5)
    assert eng.stats()["oov_rate"] == pytest.approx(5.0 / 8.0)
