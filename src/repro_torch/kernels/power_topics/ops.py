"""The power-topic selection of the POBP training step: its CUDA kernel's
wrapper and its plain PyTorch version.

`power_topics` computes, for each power word ``sel_w[p]``, the ids of the
``Pk`` largest entries of the residual row ``r_wk[sel_w[p], :]``: the
port's counterpart of the JAX package's
``core/power.py::select_power_topics`` (a row gather, then
``lax.top_k``), in ``lax.top_k``'s order exactly: values descending under
the float total order (-0.0 below +0.0), ties to the lower topic id.  On
a CUDA tensor it launches the hand-written kernel
(``csrc/power_topics.cu``: a CTA a power word reads its row once into
shared memory, bounds the row's Pk-th value from below by its groups'
maxima and ranks the few keys above the bound, with an exact radix select
for rows of many ties; no [P, K] copy) and raises if the kernel cannot
build, launch or take the shape; on a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import check_args, device_int, launcher

_SOURCE = "power_topics"
_HIST_BINS = 2 * 1024              # the kernel's two 10-bit histograms
_CAP = 256                         # candidates the kernel ranks directly
_MAX_THREADS = 512


class TopicsPlan(NamedTuple):
    """How the kernel runs at one row width: ``threads`` a CTA (one CTA a
    power word), ``keys_per_thread`` of the row's keys each thread visits
    in a pass, and ``smem_bytes`` of dynamic shared memory a CTA (the row's
    keys, the histograms, the candidates and winners)."""
    threads: int
    keys_per_thread: int
    smem_bytes: int


def topics_launch_plan(K: int, Pk: int) -> TopicsPlan:
    """The kernel's shape at rows of ``K`` topics and ``Pk`` winners: about
    16 keys a thread, in a power of two of threads from 32 to 512 (128 at
    K = 2000, 512 at K = 10,000).  Every caller runs the same algorithm;
    only the row width differs."""
    K, Pk = int(K), int(Pk)
    if not 1 <= Pk <= K:
        raise ValueError(f"power_topics needs 1 <= Pk <= K, got Pk={Pk}, "
                         f"K={K}")
    threads = 32
    while threads < _MAX_THREADS and threads * 16 < K:
        threads *= 2
    n_cand = -(-max(_CAP, Pk) // 4) * 4
    return TopicsPlan(threads, -(-K // threads),
                      8 * _CAP + 4 * (_HIST_BINS + n_cand + K))


def power_topics_plain(r_wk: torch.Tensor, sel_w: torch.Tensor,
                       Pk: int) -> torch.Tensor:
    """The selection in plain PyTorch ops: a stable descending sort of the
    gathered rows' order-preserving int32 keys (``lax.top_k``'s total
    order, -0.0 below +0.0), then the first ``Pk``: int32 [P, Pk]."""
    rows = r_wk[sel_w.long()].to(torch.float32).contiguous()
    keys = rows.view(torch.int32)
    keys = torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys)
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices
    return order[:, :Pk].to(torch.int32)


@launcher(_SOURCE, "r_wk", power_topics_plain)
def power_topics(kernel, stream, r_wk: torch.Tensor, sel_w: torch.Tensor,
                 Pk: int) -> torch.Tensor:
    """Per power word, the ids of its ``Pk`` largest residuals, in
    ``lax.top_k``'s order: int32 [P, Pk].

    r_wk [W, K] float32; sel_w [P] int32, each id in [0, W) (the kernel
    reads a row outside as all zeros; the plain version raises).  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel,
    counted as ``power_topics``, and raises on a shape it cannot take (K
    past the rows' room in shared memory).  Exact: the same bits from
    both, launch after launch.
    """
    if r_wk.dim() != 2 or sel_w.dim() != 1:
        raise ValueError(f"r_wk must be [W, K] and sel_w [P], got shapes "
                         f"{tuple(r_wk.shape)} and {tuple(sel_w.shape)}")
    (W, K), P = r_wk.shape, sel_w.shape[0]
    plan = topics_launch_plan(K, Pk)
    for name, n in (("P", P), ("W", W)):
        if n >= 2 ** 31:
            raise ValueError(f"{name} = {n} is past the kernel's int "
                             f"argument (< 2^31)")
    check_args("r_wk", {"r_wk": (r_wk, torch.float32, (W, K)),
                        "sel_w": (sel_w, torch.int32, (P,))})
    out = torch.empty((P, Pk), dtype=torch.int32, device=r_wk.device)
    # the first call on a device lets the kernel opt in to all the shared
    # memory a block may have
    room = device_int(_SOURCE, "power_topics_configure", r_wk.device)
    if plan.smem_bytes > room:
        raise ValueError(
            f"power_topics: K={K}, Pk={Pk} need {plan.smem_bytes} bytes "
            f"of shared memory a block, past the {room} of {r_wk.device}")
    kernel.launch(kernel.lib.power_topics, r_wk.data_ptr(), sel_w.data_ptr(),
                  out.data_ptr(), P, Pk, W, K, plan.threads, stream)
    return out
