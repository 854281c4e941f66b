"""The dense BP message update: its CUDA kernel's wrapper and its plain
PyTorch version.

`bp_update` is the port's counterpart of the JAX package's
``kernels/bp_update/kernel.py::bp_update_tokens`` together with the
per-token gathers its caller ``ops.py::dense_sweep_pallas`` makes: the
kernel reads each token's theta and phi rows by index, so the port passes
the [D, K] theta and [W, K] phi with the token-major ids, not [T, K]
gathers, and needs no TPU lane padding.  On a CUDA tensor it launches the
hand-written kernel (``csrc/bp_update.cu``) and raises if the kernel
cannot build or launch; on a CPU tensor it runs `bp_update_plain`.

The source has two paths: threads that keep a token's rows in registers
and read each row once (K <= ``REGISTER_MAX_K``), and two passes over the
row, for any K; `bp_launch_plan` picks by K.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import check_args, launcher

_SOURCE = "bp_update"
REGISTER_MAX_K = 2048              # 4 topics a thread x 512 threads


class BpPlan(NamedTuple):
    """How the kernel runs at one K: ``path`` "registers" (a CTA of
    ``threads`` threads a token, each keeping 4 topics of the token's rows
    in registers) or "twopass" (a warp a token, 8 a CTA of ``threads``, two
    passes over the row)."""
    path: str
    threads: int


def bp_launch_plan(K: int) -> BpPlan:
    """The kernel's path and shape at ``K`` topics: the register path up to
    ``REGISTER_MAX_K`` (the K = 2000 cell) with the fewest warps a token
    (1 to 16) that cover K at 4 topics a thread; the two-pass path past it
    (the K = 10,000 cell).  Every K >= 1 has a plan."""
    K = int(K)
    if K < 1:
        raise ValueError(f"K={K}: the dense sweep needs K >= 1")
    if K > REGISTER_MAX_K:
        return BpPlan("twopass", 256)
    return BpPlan("registers", 32 * -(-K // 128))


def bp_update_plain(word_ids, doc_ids, counts_t, mu_t, theta, phi_wk,
                    phi_tot, *, alpha: float, beta: float, wbeta: float):
    """The update in plain PyTorch ops: the counterpart of the JAX
    package's ``kernels/bp_update/ref.py::bp_update_tokens_ref`` with the
    theta and phi gathers written out.  Returns (mu_new [T, K], r_tok
    [T, K]); the inputs are not modified."""
    self_c = counts_t * mu_t
    th = theta[doc_ids.long()] - self_c + alpha
    ph = phi_wk[word_ids.long()] - self_c + beta
    pt = phi_tot[None, :] - self_c + wbeta
    u = th * ph / pt
    mu_new = u / torch.sum(u, dim=-1, keepdim=True).clamp_min(1e-30)
    return mu_new, counts_t * torch.abs(mu_new - mu_t)


def _check_cuda_args(word_ids, doc_ids, counts_t, mu_t, theta, phi_wk,
                     phi_tot):
    T, K = mu_t.shape
    want = {"word_ids": (word_ids, torch.int32, (T,)),
            "doc_ids": (doc_ids, torch.int32, (T,)),
            "counts_t": (counts_t, torch.float32, (T, 1)),
            "mu_t": (mu_t, torch.float32, (T, K)),
            "theta": (theta, torch.float32, (theta.shape[0], K)),
            "phi_wk": (phi_wk, torch.float32, (phi_wk.shape[0], K)),
            "phi_tot": (phi_tot, torch.float32, (K,))}
    check_args("mu_t", want)


@launcher(_SOURCE, "mu_t", bp_update_plain)
def bp_update(kernel, stream, word_ids, doc_ids, counts_t, mu_t, theta,
              phi_wk, phi_tot, *, alpha: float, beta: float, wbeta: float):
    """One dense (all-topic) BP update of the token-major messages.

    word_ids, doc_ids [T] int32 (each in range: the kernel reads
    ``phi_wk[word_ids[t]]`` and ``theta[doc_ids[t]]`` unchecked); counts_t
    [T, 1]; mu_t [T, K]; theta [D, K] (sum of c*mu per document, the
    token's own count included); phi_wk [W, K]; phi_tot [K].  Returns new
    tensors (mu_new [T, K], r_tok [T, K]) as `bp_update_plain` documents.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on ``bp_launch_plan(K)``, counted as ``bp_update``.
    Either path sums in a fixed order, so a launch repeats bit for bit.
    """
    _check_cuda_args(word_ids, doc_ids, counts_t, mu_t, theta, phi_wk,
                     phi_tot)
    T, K = mu_t.shape
    plan = bp_launch_plan(K)
    mu_new = torch.empty_like(mu_t)
    r_tok = torch.empty_like(mu_t)
    kernel.launch(
        kernel.lib.bp_update, word_ids.data_ptr(), doc_ids.data_ptr(),
        counts_t.data_ptr(), mu_t.data_ptr(), theta.data_ptr(),
        phi_wk.data_ptr(), phi_tot.data_ptr(), mu_new.data_ptr(),
        r_tok.data_ptr(), T, K, float(alpha), float(beta), float(wbeta),
        int(plan.path == "registers"), plan.threads, stream)
    return mu_new, r_tok
