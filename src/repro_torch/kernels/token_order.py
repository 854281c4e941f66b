"""The orders in which the port's kernels visit a mini-batch's tokens.

The packed sweep walks the tokens in `sweep_order`; the fixed-order sums
(the word scatter, the carry sweep's d/r fold) add each key's counted
tokens along its run of `token_runs`; the carry fold cuts a long run into
the chunks of `token_chunks`, at most `FOLD_CHUNK` tokens each.  Made once
per mini-batch (``core.types.TokenLayout`` caches them), read by every
launch of the mini-batch.
"""

from __future__ import annotations

from typing import Optional

import torch

# The most counted tokens of a run that one warp of the carry sweep's d/r
# fold sums (``kFoldChunk`` of ``csrc/power_sweep_carry.cu``)
FOLD_CHUNK = 64


def sweep_order(keys: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The packed sweep's token order: the tokens stably sorted by ``keys``
    [T] (non-negative: a word id, or a row of the packed buffers), every
    token of count 0 after every counted one.  int32 [T].  Sorted by word,
    the counted tokens of each power row are contiguous (a row is one
    word), and the padding slots (word 0, count 0) gather at the end."""
    zero = (counts.reshape(-1) == 0).long()
    return torch.argsort(keys.long() + (zero << 32), stable=True).to(
        torch.int32)


def token_runs(keys: torch.Tensor, counts: torch.Tensor, num_keys: int,
               order: Optional[torch.Tensor] = None):
    """The counted tokens grouped by key, for the fixed-order segmented
    sums: ``(order, starts)`` with ``order`` the `sweep_order` of ``keys``
    [T] (given, or made here) and ``starts`` int32 [num_keys + 1], so that
    the counted tokens of key q, in token order, are
    ``order[starts[q]:starts[q + 1]]``.  Keys must lie in [0, num_keys)."""
    if order is None:
        order = sweep_order(keys, counts)
    o = order.long()
    sorted_keys = keys.reshape(-1).long()[o] + (
        (counts.reshape(-1)[o] == 0).long() << 32)
    starts = torch.searchsorted(
        sorted_keys, torch.arange(num_keys + 1, device=keys.device))
    return order, starts.to(torch.int32)


def token_chunks(starts: torch.Tensor) -> torch.Tensor:
    """The runs ``starts`` [Q + 1] (of `token_runs`) cut into chunks of at
    most `FOLD_CHUNK` counted tokens, in run order: a run of n tokens has
    ceil(n / FOLD_CHUNK) chunks (none when it is empty), and chunk i covers
    the run positions ``starts[q] + i * FOLD_CHUNK`` up to the next chunk's
    or the run's end.  Returns ``split`` (int32 [E]), the first run
    position of every chunk of the runs cut in two or more, in key and
    chunk order: the carry fold's warps of those chunks.  Reads one size
    back to the host."""
    C = FOLD_CHUNK
    per = (starts.diff().long() + C - 1) // C
    keys = (per > 1).nonzero().squeeze(1)
    reps = per[keys]
    E = int(reps.sum())
    base = torch.repeat_interleave(starts[keys].long(), reps, output_size=E)
    at = torch.repeat_interleave(reps.cumsum(0) - reps, reps, output_size=E)
    idx = torch.arange(E, device=starts.device) - at
    return (base + idx * C).to(torch.int32)
