"""The collapsed Gibbs chain: its CUDA kernels' wrappers and their plain
PyTorch versions.

`gibbs_sweep` runs one full sequential sweep of the reference's
``core/gibbs.py::gibbs_sweep`` (the ``lax.scan`` over every token), IN
PLACE on the topic assignments and the three count tensors, where the
reference returns new arrays.  The draw of each token is Gumbel-max, as
the reference's ``jax.random.categorical`` is: ``argmax(g + logits)``, the
lowest topic on a tie.  The noise ``g`` is injected as a float32 [T, K]
tensor, or drawn from a 64-bit seed by Philox4x32-10: on the card by
`gibbs_noise`, a pre-pass over every SM ahead of the chain, whose plain
version `philox_gumbel` makes the same numbers in PyTorch (the mapping is
in ``csrc/gibbs_sweep.cu``).  On a CUDA tensor a wrapper launches its
kernel and raises if it cannot build or launch; on a CPU tensor it runs
the plain version (for the chain, a loop over the tokens).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (build, check_args, device_int, launcher,
                                 raise_on_error)

_SOURCE = "gibbs_sweep"
_MASK = 0xFFFFFFFF
# the pre-pass draws at most this many bytes of noise at a time; a sweep of
# more tokens runs the pre-pass and the chain once a chunk of tokens
NOISE_CHUNK_BYTES = 1 << 30


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return seed


def chain_scalars(alpha: float, beta: float, W: int):
    """alpha, beta and W * beta as float32 values (Python floats), rounded
    as the reference's weak-typed scalars are: W * beta formed in double,
    then rounded once."""
    return (float(np.float32(alpha)), float(np.float32(beta)),
            float(np.float32(int(W) * beta)))


# ----------------------------------------------------------------- noise

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of ``m * x`` for a 32-bit constant ``m`` and
    int64 ``x`` in [0, 2^32), without overflowing int64: x in 16-bit
    halves."""
    p_lo, p_hi = m * (x & 0xFFFF), m * (x >> 16)     # each < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit
    counter words and a 64-bit key (k0, k1): the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
    return c0, c1, c2, c3


def philox_gumbel(seed: int, sweep: int, T: int, K: int, device, *,
                  t0: int = 0) -> torch.Tensor:
    """The kernel's own noise as a float32 [T, K] tensor, of tokens t0 ..
    t0 + T - 1: Philox4x32-10 with key (seed's low and high 32 bits) and
    counter (k, t, sweep, 0), its first output word x mapped to
    u = ((x >> 9) + 0.5) * 2^-23 and g = -log(-log(u)).  In int64 tensor
    ops, T * K elements at a time: the plain version of `gibbs_noise`."""
    k = torch.arange(K, dtype=torch.int64, device=device)
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=device)
    zeros = torch.zeros((T, K), dtype=torch.int64, device=device)
    x, *_ = philox4x32(k[None, :] + zeros, t[:, None] + zeros,
                       zeros + (int(sweep) & _MASK), zeros,
                       int(seed) & _MASK, (int(seed) >> 32) & _MASK)
    u = ((x >> 9).to(torch.float32) + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


# ----------------------------------------------------------------- sweep

def gibbs_sweep_plain(z, n_dk, n_wk, n_k, doc_ids, word_ids, noise_or_seed,
                      *, alpha: float, beta: float, W: int, sweep: int = 0):
    """One sweep in plain PyTorch ops, a loop over the tokens in order, IN
    PLACE; ``noise_or_seed`` a float32 [T, K] tensor, or an int seed whose
    `philox_gumbel` noise is made first.  Returns (z, n_dk, n_wk, n_k)."""
    T, K = z.shape[0], n_k.shape[0]
    if isinstance(noise_or_seed, torch.Tensor):
        noise = noise_or_seed
    else:
        noise = philox_gumbel(noise_or_seed, sweep, T, K, n_k.device)
    a, b, wb = chain_scalars(alpha, beta, W)
    one = torch.ones(1, dtype=n_k.dtype, device=n_k.device)
    docs, words = doc_ids.tolist(), word_ids.tolist()
    for t in range(T):
        rows = (n_dk[docs[t]], n_wk[words[t]], n_k)
        for row in rows:
            row.index_add_(0, z[t:t + 1].long(), -one)
        logits = (torch.log(rows[0] + a) + torch.log(rows[1] + b)
                  ) - torch.log(n_k + wb)
        new = torch.argmax(noise[t] + logits).reshape(1)
        for row in rows:
            row.index_add_(0, new, one)
        z[t:t + 1] = new
    return z, n_dk, n_wk, n_k


def cached_topic_limit(device) -> int:
    """The largest K whose per-topic caches fit the chain's shared memory
    on ``device`` (a CUDA device); past it the chain keeps them in device
    memory."""
    return device_int(_SOURCE, "gibbs_sweep_cached_topics",
                      torch.device(device))


def block_threads(K: int) -> int:
    """The chain's block size at K topics: a power of two with about 8
    topics a thread (two chunks of 4), at least a warp and at most 512
    threads.  At K = 2000, 256 threads ran faster than 512 and 1024 on an
    H100 (``chip_smoke.py`` phase 2 times the three in turns)."""
    return min(512, max(32, 1 << (-(-int(K) // 8) - 1).bit_length()))


def gibbs_noise_plain(seed: int, sweep: int, T: int, K: int, device, *,
                      t0: int = 0, out=None) -> torch.Tensor:
    """`philox_gumbel` into ``out`` when given: the plain version of
    `gibbs_noise`."""
    got = philox_gumbel(_check_seed(seed), sweep, int(T), int(K),
                        torch.device(device), t0=t0)
    return got if out is None else out.copy_(got)


@launcher(_SOURCE, "device", gibbs_noise_plain)
def gibbs_noise(kernel, stream, seed: int, sweep: int, T: int, K: int,
                device, *, t0: int = 0, out=None) -> torch.Tensor:
    """The chain's Philox noise of tokens t0 .. t0 + T - 1 as a float32
    [T, K] tensor (into ``out`` when given).  On a CUDA device it launches
    the pre-pass kernel, a grid over every SM, counted as
    ``gibbs_noise``; on the CPU it is `philox_gumbel`."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    seed, T, K = _check_seed(seed), int(T), int(K)
    if out is None:
        out = torch.empty((T, K), dtype=torch.float32, device=dev)
    if out.device != dev:
        raise ValueError(f"out is on {out.device}, not {dev}")
    check_args("out", {"out": (out, torch.float32, (T, K))})
    kernel.launch(kernel.lib.gibbs_noise, out.data_ptr(), seed & _MASK,
                  seed >> 32, int(sweep) & _MASK, int(t0), T, K,
                  torch.cuda.get_device_properties(dev).multi_processor_count,
                  stream)
    return out


@launcher(_SOURCE, "n_k", gibbs_sweep_plain)
def gibbs_sweep(kernel, stream, z, n_dk, n_wk, n_k, doc_ids, word_ids,
                noise_or_seed, *, alpha: float, beta: float, W: int,
                sweep: int = 0):
    """One sequential collapsed-Gibbs sweep over the T tokens, IN PLACE.

    z [T] int32 topics in [0, K); n_dk [D, K], n_wk [W, K] and n_k [K]
    float32 counts of z (n_k the column sums of n_wk); doc_ids, word_ids
    [T] int32 in range; ``noise_or_seed`` a float32 [T, K] noise tensor,
    or an int in [0, 2^64) that keys the Philox noise with ``sweep``.
    Returns (z, n_dk, n_wk, n_k).  A CPU tensor runs the plain version; a
    CUDA tensor launches the chain kernel (one CTA of `block_threads(K)`
    threads), counted as ``gibbs_sweep``.
    With a seed the `gibbs_noise` pre-pass draws the noise first, and the
    sweep runs as one pre-pass and one chain launch a chunk of
    `NOISE_CHUNK_BYTES` of noise (one of each at up to 2^28 / K tokens).
    The kernel chooses the plain version's topics on the same noise, so
    the two agree bit for bit.  Ids and z must be in range: the kernel
    reads them unchecked.
    """
    T, (K,), D = z.shape[0], n_k.shape, n_dk.shape[0]
    want = {"z": (z, torch.int32, (T,)),
            "n_dk": (n_dk, torch.float32, (D, K)),
            "n_wk": (n_wk, torch.float32, (int(W), K)),
            "n_k": (n_k, torch.float32, (K,)),
            "doc_ids": (doc_ids, torch.int32, (T,)),
            "word_ids": (word_ids, torch.int32, (T,))}
    injected = isinstance(noise_or_seed, torch.Tensor)
    if injected:
        want["noise"] = (noise_or_seed, torch.float32, (T, K))
    else:
        seed = _check_seed(noise_or_seed)
    check_args("n_k", want)
    threads = block_threads(K)
    dev = n_k.device
    a, b, wb = chain_scalars(alpha, beta, W)
    limit = device_int(_SOURCE, "gibbs_sweep_max_topics", dev)
    if K > limit:
        raise ValueError(f"K={K}: gibbs_sweep takes K <= {limit}")
    if T == 0:
        return z, n_dk, n_wk, n_k
    scratch = torch.empty(2 * K, dtype=torch.float32, device=dev)
    chunk = T if injected else max(1, min(T, NOISE_CHUNK_BYTES // (4 * K)))
    noise = noise_or_seed if injected else torch.empty(
        (chunk, K), dtype=torch.float32, device=dev)
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        if not injected:
            gibbs_noise(seed, sweep, t1 - t0, K, dev, t0=t0,
                        out=noise[:t1 - t0])
        kernel.launch(
            kernel.lib.gibbs_sweep, z.data_ptr(), n_dk.data_ptr(),
            n_wk.data_ptr(), n_k.data_ptr(), doc_ids.data_ptr(),
            word_ids.data_ptr(), noise.data_ptr(), 0 if injected else t0, t0,
            t1, K, a, b, wb, scratch.data_ptr(), threads, stream)
    return z, n_dk, n_wk, n_k


def reduce_floor(T: int, K: int, device) -> torch.Tensor:
    """Launch the chain's skeleton on ``device`` (a CUDA device): T steps of
    the sweep's one-barrier block argmax over K topics with its block size,
    no loads and no logs; T times a step is the sweep's latency floor.  Not
    counted as ``gibbs_sweep``: it computes nothing of the chain.  Returns
    the int32 [1] tensor the last step writes."""
    dev = torch.device(device)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = build.load(_SOURCE)
    with torch.cuda.device(dev):
        err = lib.gibbs_reduce_floor(
            out.data_ptr(), int(T), int(K), block_threads(K),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(_SOURCE, err, "gibbs_reduce_floor kernel launch")
    return out
