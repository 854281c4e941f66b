"""The port's run tables (``repro_torch.kernels.token_order``):
`token_runs`, the counted tokens grouped by key in token order, and
`token_chunks`, those runs cut into chunks of at most ``FOLD_CHUNK`` tokens
for the carry sweep's d/r fold, each made once per mini-batch and cached on
the `TokenLayout` of ``repro_torch.core.types``.  The file imports neither
``jax`` nor ``repro``."""

import numpy as np
import pytest
import torch

from repro_torch.core.types import MiniBatch
from repro_torch.kernels.token_order import (FOLD_CHUNK, token_chunks,
                                             token_runs)

C = FOLD_CHUNK


def _starts(lengths):
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                        dtype=torch.int32)


def _chunks_by_hand(lengths):
    """Each key's chunks as (start, end) run positions, cut every C tokens
    from the run's start."""
    out, pos = [], 0
    for n in lengths:
        out.append([(lo, min(lo + C, pos + n))
                    for lo in range(pos, pos + n, C)])
        pos += n
    return out


def _chunks_of(starts, split):
    """Each key's chunks as (start, end) run positions, read from the
    table: a run of at most C tokens is its own one chunk, a longer one is
    cut at the ``split`` positions that fall inside it."""
    out, cuts = [], split.tolist()
    for q in range(starts.shape[0] - 1):
        lo, hi = int(starts[q]), int(starts[q + 1])
        if hi - lo <= C:
            out.append([(lo, hi)] if hi > lo else [])
            continue
        at = [a for a in cuts if lo <= a < hi]
        out.append(list(zip(at, at[1:] + [hi])))
    return out


@pytest.mark.parametrize("lengths", [
    [0, 1, C, C + 1, 2 * C, 3 * C + 5, 0, 4045],   # edges and a head run
    [0, 0, 0],                                      # nothing counted
    [C] * 7,                                        # every run one whole chunk
    [C + 1],                                        # one run, cut once
])
def test_chunks_cover_each_run_once_in_order(lengths):
    starts = _starts(lengths)
    split = token_chunks(starts)
    assert split.dtype == torch.int32 and split.dim() == 1
    want = _chunks_by_hand(lengths)
    got = _chunks_of(starts, split)
    for q, (n, chunks) in enumerate(zip(lengths, got)):
        assert len(chunks) == -(-n // C)          # none for an empty run
        # the chunks tile the run in run order, at most C tokens each
        assert [a for a, _ in chunks] == list(range(int(starts[q]),
                                                    int(starts[q + 1]), C))
        assert all(0 < b - a <= C for a, b in chunks)
        if chunks:
            assert chunks[0][0] == int(starts[q])
            assert chunks[-1][1] == int(starts[q + 1])
            assert all(a == b for (_, b), (a, _) in zip(chunks, chunks[1:]))
    assert got == want
    # split: the first positions of the chunks of the runs cut in two or
    # more, in key and chunk order; a run of at most C stays one chunk
    assert split.tolist() == [a for chunks in want if len(chunks) > 1
                              for a, _ in chunks]


def test_chunks_of_random_runs_match_the_hand_cut():
    rng = np.random.default_rng(0)
    lengths = rng.zipf(1.3, 500).clip(max=10 * C)
    lengths[rng.random(500) < 0.2] = 0
    split = token_chunks(_starts(lengths))
    want = _chunks_by_hand(lengths)
    assert _chunks_of(_starts(lengths), split) == want
    assert split.tolist() == [a for c in want if len(c) > 1 for a, _ in c]


def _batch(seed, D=200, L=12, W=30):
    rng = np.random.default_rng(seed)
    words = (rng.random((D, L)) ** 3 * W).astype(np.int32)   # a skewed law
    counts = rng.integers(0, 3, (D, L)).astype(np.float32)
    words[counts == 0] = 0
    words[:, 0] = 7                        # word 7 in every document
    counts[:, 0] = 1.0
    return MiniBatch(torch.from_numpy(words), torch.from_numpy(counts))


def test_runs_list_each_keys_counted_tokens_in_token_order():
    mb = _batch(1)
    W = 30
    words, counts = mb.word_ids.reshape(-1), mb.counts.reshape(-1, 1)
    order, starts = token_runs(words, counts, W)
    counted = (counts[:, 0] > 0).numpy()
    for w in range(W):
        want = np.flatnonzero((words.numpy() == w) & counted)
        got = order[int(starts[w]):int(starts[w + 1])].numpy()
        assert np.array_equal(got, want), w
    assert int(starts[W]) == int(counted.sum())


def test_word_chunks_are_made_once_per_minibatch():
    mb = _batch(2)
    W = 30
    layout = mb.token_layout()
    got = layout.word_chunks(W)
    assert layout.word_chunks(W) is got
    starts = layout.word_runs(W)[1]
    assert torch.equal(got, token_chunks(starts))
    # word 7 is in all 200 documents: its run is cut, every chunk listed
    n7 = int(starts[8] - starts[7])
    assert n7 >= 200
    assert [a for a in got.tolist() if starts[7] <= a < starts[8]] == list(
        range(int(starts[7]), int(starts[8]), C))
