"""Two-step power word / power topic selection (paper §3.1, Fig. 2) and the
packed gather and scatters of the sparse sync: the counterpart of
``repro.core.power``.

Every sync-side matrix is [W, K] (rows are words), so power-word selection
is a row pick and power-topic selection a per-row column pick.  The
scatters update their matrix IN PLACE, where the reference returns a new
array.  `pack_rows` and `scatter_add_rows` run the hand-written CUDA
kernels on a CUDA tensor (``kernels/power_pack``), their plain versions on
a CPU tensor.

Top-k ties.  Topic selection (`select_power_topics`) follows
``lax.top_k``'s order exactly: values descending under the float total
order (-0.0 below +0.0), ties to the lower topic id, on the card (the
kernel of ``kernels/power_topics``) and on the CPU (its plain version)
alike.  Word selection runs ``torch.topk``, which does not promise
``lax.top_k``'s tie order.  Ties arise at zero residual (words no token
touched); which of those is picked moves no statistic, because no token
updates through them.  On a capacity-laddered run
(``select_power_words_live``) the dead slots past the live count all
point at the first guard row, an all-zero row of the residual, so their
topics are 0 .. Pk-1 and carry exact zeros into the packed buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.power_pack.ops import pack_rows as _pack
from repro_torch.kernels.power_pack.ops import scatter_add_rows as _scatter_add
from repro_torch.kernels.power_topics.ops import power_topics as _topics


def select_power_words(r_w: torch.Tensor, num_power_words: int
                       ) -> torch.Tensor:
    """Top-``num_power_words`` vocabulary ids by word residual (Eq. 10),
    int32 [P], largest first."""
    return torch.topk(r_w, num_power_words).indices.to(torch.int32)


def num_live_power_words(live_w: int, lambda_w: float) -> int:
    """``P_live = max(1, floor(lambda_w * live_w))``, the product formed in
    float32 as the reference traces it (a double product can floor to
    another count next to an integer)."""
    return max(1, int(np.floor(np.float32(lambda_w) * np.float32(live_w))))


def select_power_words_live(r_w: torch.Tensor, num_power_words: int,
                            live_w: int, lambda_w: float) -> torch.Tensor:
    """Power-word selection on a capacity-laddered run: int32 [P].

    ``r_w`` is [W_cap]; rows in [live_w, W_cap) are guard rows and are
    never selected (masked to -inf), and only the first
    `num_live_power_words` slots hold power words, so the selection depends
    on the live vocabulary, never on the rung.  The shape stays
    [num_power_words]: every slot past the live count points at row
    ``live_w``, the first guard row, which no token has and whose residual
    and phi rows are zero, so those slots pack and scatter exact zeros.
    """
    W = r_w.shape[0]
    if not 0 < live_w < W:
        raise ValueError(f"live_w={live_w} must lie in [1, {W}): a guard row "
                         f"must exist above the live vocabulary")
    p_live = num_live_power_words(live_w, lambda_w)
    if p_live > num_power_words:
        raise ValueError(f"{p_live} live power words exceed the "
                         f"{num_power_words} slots")
    masked = r_w.masked_fill(
        torch.arange(W, device=r_w.device) >= live_w, float("-inf"))
    idx = torch.topk(masked, num_power_words).indices.to(torch.int32)
    idx[p_live:] = live_w
    return idx


def select_power_topics(r_wk: torch.Tensor, word_idx: torch.Tensor,
                        num_power_topics: int) -> torch.Tensor:
    """Per power word, its top-``num_power_topics`` topic ids by residual
    (Fig. 4 lines 13/28): int32 [P, Pk], in ``lax.top_k``'s order exactly
    (values descending, -0.0 below +0.0, ties to the lower topic id).  A
    CUDA tensor runs the hand-written kernel, which reads each selected row
    once and makes no [P, K] copy; a CPU tensor its plain version."""
    return _topics(r_wk, word_idx, num_power_topics)


def word_to_row(word_idx: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Inverse map: word -> its row in the packed buffers, or -1.  A live-W
    selection repeats the guard row at its dead slots; which of them that
    row maps to is unspecified, and moves nothing: no token has the guard
    row's word (`token_power_rows` reads only the tokens' words)."""
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
