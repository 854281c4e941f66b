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

import ctypes
import math

import torch

from repro_torch.kernels import (build, check_args, count_launch,
                                 zeroed_counters)

_SOURCE = "segment_sum"
_MAX_TOPIC_WARPS = 8
_TOPIC_STAGE = 1024                # topic_sum: pairs a warp stages at a time
_smem_optin: dict[int, int] = {}   # device index -> shared memory a block may have


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.word_rows_sum.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.word_rows_sum.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
        lib.word_rows_sum.restype = ctypes.c_int
        lib.topic_sum.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
        lib.topic_sum.restype = ctypes.c_int
        lib.segment_sum_smem_optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.segment_sum_smem_optin.restype = ctypes.c_int
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.segment_sum_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


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


def word_rows_sum(order, starts, values, vocab_size: int):
    """Sum token rows into word rows in a fixed order.

    order [T] int32 and starts [W + 1] int32 are the runs of
    ``TokenLayout.word_runs(W)`` (or `core.types.token_runs`): the tokens of
    word w are ``order[starts[w]:starts[w + 1]]``; values [T, K] float32.
    Returns a new [W, K] tensor, ``out[w] = sum over the run of w of
    values[t]`` in run order (zeros for a word with no run).  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel, counted in
    ``word_rows_sum.launches``; it sums in run order, so it repeats bit for
    bit, and equals the plain version bit for bit.  order and starts must
    be in range: the kernel reads them unchecked.
    """
    if values.device.type == "cpu":
        return word_rows_sum_plain(order, starts, values, vocab_size)
    if values.device.type != "cuda":
        raise ValueError(f"word_rows_sum runs on CPU or CUDA tensors, not "
                         f"{values.device}")
    T, K = values.shape
    W = int(vocab_size)
    check_args("values", {"order": (order, torch.int32, (T,)),
                          "starts": (starts, torch.int32, (W + 1,)),
                          "values": (values, torch.float32, (T, K))})
    dev = values.device
    out = torch.empty((W, K), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.word_rows_sum(order.data_ptr(), starts.data_ptr(),
                                values.data_ptr(), out.data_ptr(), W, K,
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "word_rows_sum kernel launch")
    count_launch(word_rows_sum)
    return out


word_rows_sum.launches = 0


# ---------------------------------------------------------------- topics

def topic_sum_plain(sel_k, vals, base):
    """``base + s`` with ``s[k]`` the sum of ``vals[p, j]`` over the pairs
    with ``sel_k[p, j] == k`` (one ``index_add_``): a new [K] tensor."""
    return base + torch.zeros_like(base).index_add_(
        0, sel_k.reshape(-1).long(), vals.reshape(-1))


def _topic_plan(lib: ctypes.CDLL, device: torch.device, K: int, Pk: int):
    """(warps, stage) of a topic_sum CTA at K topics and Pk pairs a row:
    each warp keeps a [K] row in shared memory and stages ``stage`` pairs
    (at least a row's, a multiple of 4), up to 8 warps within what a block
    may opt in to; without room to stage, warps add straight from device
    memory (stage 0), as far as one [K] row fits."""
    optin = _smem_optin.get(device.index)
    if optin is None:
        got = ctypes.c_int(0)
        _raise_on(lib, lib.segment_sum_smem_optin(ctypes.byref(got)),
                  f"reading the shared memory of {device}")
        optin = _smem_optin[device.index] = got.value
    stage = -(-max(int(Pk), _TOPIC_STAGE) // 4) * 4 if Pk > 0 else 0
    for st in ((stage, 0) if stage else (0,)):
        warps = min(_MAX_TOPIC_WARPS,
                    optin // (4 * (max(K, 1) + (2 * (st + 4) if st else 0))))
        if warps >= 1:
            return warps, st
    raise ValueError(f"K={K}: topic_sum takes K <= {optin // 4} on "
                     f"{device} (its shared memory)")


def topic_sum(sel_k, vals, base):
    """``base`` plus the per-topic sums of ``vals``: the phi_tot refresh of
    a selective iteration, ``phi_tot + zeros.index_add_(0, sel_k, d_pack)``.

    sel_k [P, Pk] int32, topics in [0, K) and distinct within a row (top-k
    selections); vals [P, Pk] float32; base [K] float32.  Returns a new [K]
    tensor.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel once, counted in ``topic_sum.launches``; it sums in a fixed
    order (rows in blocks, warps, CTAs, groups of CTAs, each in order), so
    it repeats bit for bit.  sel_k must be in range: the kernel
    reads it unchecked.
    """
    if base.device.type == "cpu":
        return topic_sum_plain(sel_k, vals, base)
    if base.device.type != "cuda":
        raise ValueError(f"topic_sum runs on CPU or CUDA tensors, not "
                         f"{base.device}")
    P, Pk = sel_k.shape
    (K,) = base.shape
    check_args("base", {"sel_k": (sel_k, torch.int32, (P, Pk)),
                        "vals": (vals, torch.float32, (P, Pk)),
                        "base": (base, torch.float32, (K,))})
    dev = base.device
    lib = _lib()
    out = torch.empty_like(base)
    with torch.cuda.device(dev):
        warps, stage = _topic_plan(lib, dev, K, Pk)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(sms, -(-P // warps)))
        group = math.isqrt(grid - 1) + 1                 # ceil(sqrt(grid))
        groups = -(-grid // group)
        stream = torch.cuda.current_stream(dev).cuda_stream
        partial = torch.empty((grid + groups, K), dtype=torch.float32,
                              device=dev)
        counters = zeroed_counters(dev, stream, sms + 2)
        err = lib.topic_sum(sel_k.data_ptr(), vals.data_ptr(),
                            base.data_ptr(), partial.data_ptr(),
                            out.data_ptr(), counters.data_ptr(), P, Pk, K,
                            grid, warps, group, stage, stream)
    _raise_on(lib, err, "topic_sum kernel launch")
    count_launch(topic_sum)
    return out


topic_sum.launches = 0
