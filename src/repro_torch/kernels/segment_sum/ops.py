"""Fixed-order segmented sums: their CUDA kernels' wrappers and their plain
PyTorch versions.

Two sums of the training step that the reference leaves to XLA as
scatter-adds (no TPU kernel): `word_rows_sum`, the [T, K] -> [W, K] word
scatter of ``core/residuals.py::token_scatter_wk``, and `topic_sum`, the
[P, Pk] -> [K] sum of the phi_tot refresh in ``core/pobp.py``.  PyTorch's
``index_add_`` on a CUDA tensor adds with atomics in an order that changes
from run to run; these kernels (``csrc/segment_sum.cu``) add in one fixed
order, so the training step repeats bit for bit on the card.  On a CUDA
tensor each launches its kernel and raises if it cannot build or launch;
on a CPU tensor each runs its plain version.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import (check_args, device_int, launcher,
                                 zeroed_counters)

_SOURCE = "segment_sum"
_MAX_TOPIC_WARPS = 8
_TOPIC_STAGE = 1024                # topic_sum: pairs a warp stages at a time


# ------------------------------------------------------------- word rows

def word_rows_sum_plain(order, starts, values, vocab_size: int):
    """``out[w] = sum of values[order[i]]`` over i in ``[starts[w],
    starts[w + 1])``, in that order, in plain PyTorch ops (one
    ``index_add_`` over the runs' positions): a new [W, K] tensor."""
    W = int(vocab_size)
    n = starts[W].long()
    lens = (starts[1:] - starts[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(W, device=values.device), lens)
    out = torch.zeros((W, values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, rows, values[order[:n].long()])


@launcher(_SOURCE, "values", word_rows_sum_plain)
def word_rows_sum(kernel, stream, order, starts, values, vocab_size: int):
    """Sum token rows into word rows in a fixed order.

    order [T] int32 and starts [W + 1] int32 are the runs of
    ``TokenLayout.word_runs(W)`` (or `kernels.token_order.token_runs`): the
    tokens of word w are ``order[starts[w]:starts[w + 1]]``; values [T, K]
    float32.  Returns a new [W, K] tensor, ``out[w] = sum over the run of w
    of values[t]`` in run order (zeros for a word with no run).  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel,
    counted as ``word_rows_sum``; it sums in run order, so it repeats bit
    for bit, and equals the plain version bit for bit.  order and starts
    must be in range: the kernel reads them unchecked.
    """
    T, K = values.shape
    W = int(vocab_size)
    check_args("values", {"order": (order, torch.int32, (T,)),
                          "starts": (starts, torch.int32, (W + 1,)),
                          "values": (values, torch.float32, (T, K))})
    out = torch.empty((W, K), dtype=torch.float32, device=values.device)
    kernel.launch(kernel.lib.word_rows_sum, order.data_ptr(),
                  starts.data_ptr(), values.data_ptr(), out.data_ptr(), W, K,
                  stream)
    return out


# ---------------------------------------------------------------- topics

def topic_sum_plain(sel_k, vals, base):
    """``base + s`` with ``s[k]`` the sum of ``vals[p, j]`` over the pairs
    with ``sel_k[p, j] == k`` (one ``index_add_``): a new [K] tensor."""
    return base + torch.zeros_like(base).index_add_(
        0, sel_k.reshape(-1).long(), vals.reshape(-1))


def _topic_plan(device: torch.device, K: int, Pk: int):
    """(warps, stage) of a topic_sum CTA at K topics and Pk pairs a row:
    each warp keeps a [K] row in shared memory and stages ``stage`` pairs
    (at least a row's, a multiple of 4), up to 8 warps within what a block
    may opt in to; without room to stage, warps add straight from device
    memory (stage 0), as far as one [K] row fits."""
    optin = device_int(_SOURCE, "segment_sum_smem_optin", device)
    stage = -(-max(int(Pk), _TOPIC_STAGE) // 4) * 4 if Pk > 0 else 0
    for st in ((stage, 0) if stage else (0,)):
        warps = min(_MAX_TOPIC_WARPS,
                    optin // (4 * (max(K, 1) + (2 * (st + 4) if st else 0))))
        if warps >= 1:
            return warps, st
    raise ValueError(f"K={K}: topic_sum takes K <= {optin // 4} on "
                     f"{device} (its shared memory)")


@launcher(_SOURCE, "base", topic_sum_plain)
def topic_sum(kernel, stream, sel_k, vals, base):
    """``base`` plus the per-topic sums of ``vals``: the phi_tot refresh of
    a selective iteration, ``phi_tot + zeros.index_add_(0, sel_k, d_pack)``.

    sel_k [P, Pk] int32, topics in [0, K) and distinct within a row (top-k
    selections); vals [P, Pk] float32; base [K] float32.  Returns a new [K]
    tensor.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel once, counted as ``topic_sum``; it sums in a fixed order
    (rows in blocks, warps, CTAs, groups of CTAs, each in order), so it
    repeats bit for bit.  sel_k must be in range: the kernel reads it
    unchecked.
    """
    P, Pk = sel_k.shape
    (K,) = base.shape
    check_args("base", {"sel_k": (sel_k, torch.int32, (P, Pk)),
                        "vals": (vals, torch.float32, (P, Pk)),
                        "base": (base, torch.float32, (K,))})
    dev = base.device
    out = torch.empty_like(base)
    warps, stage = _topic_plan(dev, K, Pk)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(sms, -(-P // warps)))
    group = math.isqrt(grid - 1) + 1                     # ceil(sqrt(grid))
    groups = -(-grid // group)
    partial = torch.empty((grid + groups, K), dtype=torch.float32,
                          device=dev)
    counters = zeroed_counters(dev, stream, sms + 2)
    kernel.launch(kernel.lib.topic_sum, sel_k.data_ptr(), vals.data_ptr(),
                  base.data_ptr(), partial.data_ptr(), out.data_ptr(),
                  counters.data_ptr(), P, Pk, K, grid, warps, group, stage,
                  stream)
    return out
