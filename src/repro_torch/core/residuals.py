"""Residual bookkeeping (Eqs. 7-10) and token-to-matrix scatters: the
counterpart of ``repro.core.residuals``."""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum.ops import word_rows_sum


def token_scatter_wk(word_ids: torch.Tensor, values: torch.Tensor,
                     vocab_size: int, runs=None) -> torch.Tensor:
    """Sum per-token values [..., K] (any leading token shape matching
    ``word_ids``) into a new [W, K] matrix by word id.

    Used for the phi delta (Eq. 3) and the residual matrix (Eq. 8).
    Padding tokens carry zero values, so their word id 0 adds nothing.  On
    a CPU tensor: ``index_add_``, which adds in token order.  On a CUDA
    tensor, where ``index_add_`` adds with atomics in no fixed order, the
    fixed-order kernel ``kernels/segment_sum::word_rows_sum`` over ``runs``
    (``TokenLayout.word_runs(W)``, made once per mini-batch, required
    there), which adds each word's tokens in token order too: the two agree
    bit for bit.  ``runs`` leaves out the tokens of count 0, whose values
    must then be 0 (as c * mu and c * |dmu| are).  The CPU path needs no
    ``runs``.
    """
    K = values.shape[-1]
    if values.device.type != "cpu":
        if runs is None:
            raise ValueError("token_scatter_wk needs the tokens' runs by "
                             "word off the CPU (TokenLayout.word_runs)")
        return word_rows_sum(*runs, values.reshape(-1, K), vocab_size)
    out = torch.zeros((vocab_size, K), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, word_ids.reshape(-1).long(),
                          values.reshape(-1, K))


def token_topic_segment_sum(doc_ids: torch.Tensor, k_tok: torch.Tensor,
                            vals: torch.Tensor, num_docs: int,
                            num_topics: int) -> torch.Tensor:
    """Sum [T, Pk] per-token values into [D, K] at (doc_ids[t], k_tok[t, j]):
    the O(T*Pk) theta refresh of the selective sweep."""
    flat = (doc_ids.long()[:, None] * num_topics + k_tok.long()).reshape(-1)
    out = torch.zeros((num_docs * num_topics,), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, flat, vals.reshape(-1)).reshape(num_docs,
                                                             num_topics)


def mean_residual(r_w: torch.Tensor, total_tokens) -> torch.Tensor:
    """Line 26 of Fig. 4: sum_w r_w / sum_{w,d} x_{w,d} (a 0-d tensor)."""
    total = torch.as_tensor(total_tokens, dtype=r_w.dtype, device=r_w.device)
    return r_w.sum() / total.clamp_min(1.0)


def packed_rw_delta(r_glob_wk: torch.Tensor, sel_w: torch.Tensor,
                    sel_k: torch.Tensor, r_pack_new: torch.Tensor
                    ) -> torch.Tensor:
    """Per-power-word change of the word residual under a packed refresh:
    ``delta[p] = sum_j r_pack_new[p, j] - r_glob[sel_w[p], sel_k[p, j]]``.

    Reads the [P, Pk] old values straight out of r_glob (no [P, K] row
    gather).  Call BEFORE scattering r_pack_new into r_glob.
    """
    old = r_glob_wk[sel_w.long()[:, None], sel_k.long()]
    return torch.sum(r_pack_new - old, dim=1)
