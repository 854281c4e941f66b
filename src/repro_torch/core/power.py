"""Two-step power word / power topic selection (paper §3.1, Fig. 2) and the
packed gather and scatters of the sparse sync: the counterpart of
``repro.core.power``.

Every sync-side matrix is [W, K] (rows are words), so power-word selection
is a row pick and power-topic selection a per-row column pick.  The
scatters update their matrix IN PLACE, where the reference returns a new
array.  `pack_rows` and `scatter_add_rows` run the hand-written CUDA
kernels on a CUDA tensor (``kernels/power_pack``), their plain versions on
a CPU tensor.

Top-k ties: ``torch.topk`` does not promise ``lax.top_k``'s tie order.
Ties arise at zero residual (words or topics no token touched); which of
those is picked moves no statistic, because no token updates through them.
The live-vocabulary selection (``select_power_words_live``) comes with the
dynamic-vocabulary slice (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.power_pack.ops import pack_rows as _pack
from repro_torch.kernels.power_pack.ops import scatter_add_rows as _scatter_add


def select_power_words(r_w: torch.Tensor, num_power_words: int
                       ) -> torch.Tensor:
    """Top-``num_power_words`` vocabulary ids by word residual (Eq. 10),
    int32 [P], largest first."""
    return torch.topk(r_w, num_power_words).indices.to(torch.int32)


def select_power_topics(r_wk: torch.Tensor, word_idx: torch.Tensor,
                        num_power_topics: int) -> torch.Tensor:
    """Per power word, its top-``num_power_topics`` topic ids by residual
    (Fig. 4 lines 13/28): int32 [P, Pk]."""
    rows = r_wk[word_idx.long()]                                 # [P, K]
    return torch.topk(rows, num_power_topics, dim=1).indices.to(torch.int32)


def word_to_row(word_idx: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Inverse map: word -> its row in the packed buffers, or -1."""
    rows = torch.full((vocab_size,), -1, dtype=torch.int32,
                      device=word_idx.device)
    rows[word_idx.long()] = torch.arange(word_idx.shape[0], dtype=torch.int32,
                                         device=word_idx.device)
    return rows


def token_power_rows(word_ids_t: torch.Tensor, sel_w: torch.Tensor,
                     vocab_size: int) -> torch.Tensor:
    """Token -> packed row in [0, P), or the guard value P for a token of
    a word that is not a power word: int32 [T]."""
    P = sel_w.shape[0]
    p_tok = word_to_row(sel_w, vocab_size)[word_ids_t.long()]
    return torch.where(p_tok >= 0, p_tok, P).to(torch.int32)


def pack_rows(mat_wk: torch.Tensor, word_idx: torch.Tensor,
              topic_idx: torch.Tensor) -> torch.Tensor:
    """The [P, Pk] power submatrix ``mat[word_idx[p], topic_idx[p, j]]``
    (the phi pack of the packed sweep), a new tensor."""
    return _pack(mat_wk, word_idx, topic_idx)


def scatter_add_rows(mat_wk: torch.Tensor, word_idx: torch.Tensor,
                     topic_idx: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
    """``mat[word_idx[p], topic_idx[p, j]] += vals[p, j]`` IN PLACE (the
    phi-delta fold, Eq. 4/15); returns mat.  Runs the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    return _scatter_add(mat_wk, word_idx, topic_idx, vals)


def scatter_set_rows(mat_wk: torch.Tensor, word_idx: torch.Tensor,
                     topic_idx: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
    """``mat[word_idx[p], topic_idx[p, j]] = vals[p, j]`` IN PLACE (the
    residual refresh, Eq. 9); returns mat."""
    rows = word_idx.long()[:, None].expand(topic_idx.shape)
    return mat_wk.index_put_((rows, topic_idx.long()), vals)
