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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_args

_SOURCE = "bp_update"


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.bp_update
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 9 + [i32] * 2 + [f32] * 3 + [ptr]
        fn.restype = ctypes.c_int
        lib.bp_update_error_string.argtypes = [ctypes.c_int]
        lib.bp_update_error_string.restype = ctypes.c_char_p
    return lib


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


def bp_update(word_ids, doc_ids, counts_t, mu_t, theta, phi_wk, phi_tot, *,
              alpha: float, beta: float, wbeta: float):
    """One dense (all-topic) BP update of the token-major messages.

    word_ids, doc_ids [T] int32 (each in range: the kernel reads
    ``phi_wk[word_ids[t]]`` and ``theta[doc_ids[t]]`` unchecked); counts_t
    [T, 1]; mu_t [T, K]; theta [D, K] (sum of c*mu per document, the
    token's own count included); phi_wk [W, K]; phi_tot [K].  Returns new
    tensors (mu_new [T, K], r_tok [T, K]) as `bp_update_plain` documents.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel, counted in ``bp_update.launches``.
    """
    if mu_t.device.type == "cpu":
        return bp_update_plain(word_ids, doc_ids, counts_t, mu_t, theta,
                               phi_wk, phi_tot, alpha=alpha, beta=beta,
                               wbeta=wbeta)
    if mu_t.device.type != "cuda":
        raise ValueError(f"bp_update runs on CPU or CUDA tensors, not "
                         f"{mu_t.device}")
    _check_cuda_args(word_ids, doc_ids, counts_t, mu_t, theta, phi_wk,
                     phi_tot)
    T, K = mu_t.shape
    mu_new = torch.empty_like(mu_t)
    r_tok = torch.empty_like(mu_t)
    lib = _lib()
    with torch.cuda.device(mu_t.device):
        err = lib.bp_update(
            word_ids.data_ptr(), doc_ids.data_ptr(), counts_t.data_ptr(),
            mu_t.data_ptr(), theta.data_ptr(), phi_wk.data_ptr(),
            phi_tot.data_ptr(), mu_new.data_ptr(), r_tok.data_ptr(), T, K,
            float(alpha), float(beta), float(wbeta),
            torch.cuda.current_stream(mu_t.device).cuda_stream)
    if err:
        msg = lib.bp_update_error_string(err).decode()
        raise RuntimeError(f"bp_update kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    bp_update.launches += 1
    return mu_new, r_tok


bp_update.launches = 0
