"""The carry-resident selective sweep: its CUDA kernel's wrappers and their
plain PyTorch versions.

Two entries of one source (``csrc/power_sweep_carry.cu``), the port's
counterparts of the JAX package's
``kernels/power_sweep/ops.py::power_sweep_carry`` in its two modes,
without the TPU tile padding:

  - `power_sweep_carry`, serving mode (``update_phi=False``, the fold-in of
    ``core/infer.py``), counted in ``power_sweep_carry.launches``;
  - `power_sweep_carry_train`, training mode (``update_phi=True`` followed
    by the ``take_along_axis`` of the reference's
    ``core/pobp.py::_selective_sweep_carry_pallas``), counted in
    ``power_sweep_carry_train.launches``.  It reads the power selection
    (``sel_w``, ``sel_k``) and phi directly: the [P+1, K] phi and mask row
    tables that the TPU kernel needs (Pallas-TPU cannot gather columns) are
    never built, and the delta/residual come back packed as [P, Pk].

Which code runs is decided by the device of the tensors: on a CUDA tensor
the hand-written kernel, raising if it cannot build or launch; on a CPU
tensor the plain version.  The TPU side chooses between a full-K and a
K-blocked kernel by whether its tables fit VMEM; the CUDA source reads
rows by index from HBM and has its own two serving paths: threads that keep
their topics of a row in registers (K <= ``SERVE_REGISTER_MAX_K``), and the
K-blocked two passes, for any K; `serve_launch_plan` picks by K.  Training
takes K + 2 * Pk floats of shared memory (`power_sweep_carry_train_max_k`);
past that the wrapper raises ``ValueError``.  Both modes sum in a fixed
order (training: a second device kernel adds the d/r rows over the tokens'
runs), so every output repeats bit for bit from launch to launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, check_args
from repro_torch.kernels.power_sweep.packed import power_sweep_tokens_plain

_SOURCE = "power_sweep_carry"
SERVE_REGISTER_MAX_K = 2048        # 2 float4s a thread x 256 threads
_MAX_TRAIN_WARPS = 8
_smem_optin: dict[int, int] = {}   # device index -> usable shared memory


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.power_sweep_carry_serve
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * 10 + [i32] * 5 + [f32] * 3
                       + [i32] * 2 + [ptr])
        fn.restype = ctypes.c_int
        lib.power_sweep_carry_train.argtypes = ([ptr] * 15 + [i32] * 5
                                                + [f32] * 3 + [i32, ptr])
        lib.power_sweep_carry_train.restype = ctypes.c_int
        lib.power_sweep_carry_error_string.argtypes = [ctypes.c_int]
        lib.power_sweep_carry_error_string.restype = ctypes.c_char_p
        lib.power_sweep_carry_configure.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.power_sweep_carry_configure.restype = ctypes.c_int
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.power_sweep_carry_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


# ------------------------------------------------------------------ serving

class ServePlan(NamedTuple):
    """How the serving kernel runs at one K: ``path`` "registers" (each
    thread keeps ``V`` float4s of a token's rows in registers) or
    "kblocked" (two passes over the row, ``V`` = 0), with ``threads`` a
    CTA."""
    path: str
    V: int
    threads: int


def serve_launch_plan(K: int) -> ServePlan:
    """The serving kernel's path and shape at ``K`` topics: the register
    path up to ``SERVE_REGISTER_MAX_K`` (the K = 2000 cell), the K-blocked
    path with 256 threads past it (the K = 10,000 cell).  Every K >= 1 has
    a plan."""
    K = int(K)
    if K < 1:
        raise ValueError(f"K={K}: the serving kernel needs K >= 1")
    if K > SERVE_REGISTER_MAX_K:
        return ServePlan("kblocked", 0, 256)
    return ServePlan("registers", 1 if K <= 1024 else 2, 256)


def power_sweep_carry_plain(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                            phi_rows, *, alpha: float, beta: float,
                            wbeta: float, n_guard: int):
    """The serving sweep in plain PyTorch ops: the counterpart of the JAX
    package's ``kernels/power_sweep/ref.py::power_sweep_carry_ref`` with
    ``update_phi=False``.  A token is active when its row id is not
    ``n_guard`` and lies in ``[0, phi_rows.shape[0])``.  ``mu_t`` is
    overwritten with the new messages.  Returns (mu_t, theta_delta [D, K],
    rdoc [D])."""
    D = theta.shape[0]
    p = p_tok.long()
    doc = doc_ids.long()
    n_rows = phi_rows.shape[0]
    act = ((p >= 0) & (p < n_rows) & (p != n_guard)).to(mu_t.dtype)[:, None]
    phi_tok = phi_rows[p.clamp(0, n_rows - 1)]
    th = theta[doc] - counts_t * mu_t + alpha
    u = th * (phi_tok + beta) / (phi_tot[None, :] + wbeta) * act
    mass = torch.sum(mu_t * act, dim=-1, keepdim=True)
    denom = torch.sum(u, dim=-1, keepdim=True).clamp_min(1e-30)
    mu_new = torch.where(act > 0, u * (mass / denom), mu_t)
    cd = counts_t * (mu_new - mu_t)
    theta_delta = torch.zeros_like(theta).index_add_(0, doc, cd)
    rdoc = torch.zeros((D,), dtype=mu_t.dtype, device=mu_t.device
                       ).index_add_(0, doc, cd.abs().sum(dim=1))
    mu_t.copy_(mu_new)
    return mu_t, theta_delta, rdoc


def power_sweep_carry(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                      phi_rows, *, alpha: float, beta: float, wbeta: float,
                      n_guard: int):
    """One serving sweep over the token-major [T, K] messages.

    p_tok [T] int32, the row of ``phi_rows`` each token reads (``n_guard``,
    or any id outside the rows, freezes it); doc_ids [T] int32,
    non-decreasing (tokens are doc-contiguous, as ``MiniBatch.token_layout``
    builds them); counts_t [T, 1]; mu_t [T, K]; theta [D, K]; phi_tot [K];
    phi_rows [W', K] the normalized phi with no guard row appended,
    ``n_guard = W'``.  Serving uses ``beta = 0``, ``phi_tot = 0`` and
    ``wbeta = 1``.

    ``mu_t`` is updated IN PLACE.  Returns (mu_t, theta_delta [D, K],
    rdoc [D]).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel on ``serve_launch_plan(K)`` (any K >= 1), counted in
    ``power_sweep_carry.launches``.  The kernel sums in a fixed order on
    either path, so a launch repeats bit for bit.
    """
    if mu_t.device.type == "cpu":
        return power_sweep_carry_plain(
            p_tok, doc_ids, counts_t, mu_t, theta, phi_tot, phi_rows,
            alpha=alpha, beta=beta, wbeta=wbeta, n_guard=n_guard)
    if mu_t.device.type != "cuda":
        raise ValueError(f"power_sweep_carry runs on CPU or CUDA tensors, "
                         f"not {mu_t.device}")
    T, K = mu_t.shape
    D = theta.shape[0]
    n_rows = phi_rows.shape[0]
    check_args("mu_t", {"p_tok": (p_tok, torch.int32, (T,)),
                        "doc_ids": (doc_ids, torch.int32, (T,)),
                        "counts_t": (counts_t, torch.float32, (T, 1)),
                        "mu_t": (mu_t, torch.float32, (T, K)),
                        "theta": (theta, torch.float32, (D, K)),
                        "phi_tot": (phi_tot, torch.float32, (K,)),
                        "phi_rows": (phi_rows, torch.float32, (n_rows, K))})
    plan = serve_launch_plan(K)
    dev = mu_t.device
    theta_delta = torch.empty_like(theta)
    rdoc = torch.empty((D,), dtype=torch.float32, device=dev)
    part = (torch.empty((4 * D, K), dtype=torch.float32, device=dev)
            if plan.path == "kblocked" else None)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.power_sweep_carry_serve(
            p_tok.data_ptr(), doc_ids.data_ptr(), counts_t.data_ptr(),
            mu_t.data_ptr(), theta.data_ptr(), phi_tot.data_ptr(),
            phi_rows.data_ptr(), theta_delta.data_ptr(), rdoc.data_ptr(),
            None if part is None else part.data_ptr(), T, D, K, n_rows,
            int(n_guard), float(alpha), float(beta), float(wbeta), plan.V,
            plan.threads, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "power_sweep_carry kernel launch")
    power_sweep_carry.launches += 1
    return mu_t, theta_delta, rdoc


power_sweep_carry.launches = 0


# ----------------------------------------------------------------- training

def power_sweep_carry_train_plain(p_tok, doc_ids, counts_t, mu_t, theta,
                                  phi_tot, phi_eff_wk, sel_w, sel_k, *,
                                  alpha: float, beta: float, wbeta: float,
                                  runs=None):
    """The training sweep in plain PyTorch ops: phi gathered at the
    selection, then the per-token [T, Pk] gathers, update and fold-back of
    ``packed.power_sweep_tokens_plain`` (the same sweep as the reference's
    ``power_sweep_carry_ref(..., update_phi=True)`` over [P+1, K] tables,
    read back at ``sel_k``).  ``runs`` is the kernel's visiting order, not
    needed here.  Returns (mu_t, theta_delta [D, K], d_pack [P, Pk],
    r_pack [P, Pk]); mu_t updated IN PLACE."""
    phi_pack = phi_eff_wk[sel_w.long()[:, None], sel_k.long()]
    return power_sweep_tokens_plain(
        p_tok, doc_ids, counts_t, mu_t, theta, phi_tot, phi_pack, sel_k,
        alpha=alpha, beta=beta, wbeta=wbeta)


def _train_smem(lib: ctypes.CDLL, device: torch.device) -> int:
    """Bytes of dynamic shared memory the training kernel may use on
    ``device``.  The first call there lets the kernel opt in to all a
    block may have; it must run with that device current."""
    smem = _smem_optin.get(device.index)
    if smem is None:
        got = ctypes.c_int(0)
        _raise_on(lib, lib.power_sweep_carry_configure(ctypes.byref(got)),
                  f"configuring power_sweep_carry_train on {device}")
        smem = _smem_optin[device.index] = got.value
    return smem


def power_sweep_carry_train_max_k(Pk: int, device="cuda") -> int:
    """The largest K the training kernel takes at ``Pk`` power topics on
    ``device`` (one warp a CTA: K + 2 * Pk floats of shared memory)."""
    dev = torch.device(device)
    lib = _lib()
    with torch.cuda.device(dev):
        return _train_smem(lib, dev) // 4 - 2 * max(Pk, 1)


def power_sweep_carry_train(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                            phi_eff_wk, sel_w, sel_k, *, alpha: float,
                            beta: float, wbeta: float, runs=None):
    """One training-mode selective sweep at the (power word, power topic)
    coordinates, over the token-major [T, K] messages.

    p_tok [T] int32: each token's row of the selection, P (or any id
    outside [0, P)) for a token that is not a power token; doc_ids [T]
    int32, non-decreasing; counts_t [T, 1]; mu_t [T, K], updated IN PLACE
    at the power tokens' selected topics only; theta [D, K], read only
    (the sweep is Jacobi); phi_tot [K]; phi_eff_wk [W, K] the effective
    statistic, read at the selection only; sel_w [P] int32 the power words;
    sel_k [P, Pk] int32 each power word's topics, distinct within a row.
    sel_w and sel_k must be in range: the kernel reads them unchecked.
    ``runs`` (order [T], starts [W + 1], int32) are the tokens' runs by word
    (``TokenLayout.word_runs(W)``, made once per mini-batch): the d/r sums
    add each power row's counted tokens in that order.  The kernel needs
    them; the plain version does not.

    Returns (mu_t, theta_delta [D, K], d_pack [P, Pk], r_pack [P, Pk]);
    the caller forms theta + theta_delta.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (the sweep, then the d/r
    fold), counted once in ``power_sweep_carry_train.launches``.  Every
    sum runs in a fixed order, so all four outputs repeat bit for bit from
    launch to launch.
    """
    if mu_t.device.type == "cpu":
        return power_sweep_carry_train_plain(
            p_tok, doc_ids, counts_t, mu_t, theta, phi_tot, phi_eff_wk,
            sel_w, sel_k, alpha=alpha, beta=beta, wbeta=wbeta)
    if mu_t.device.type != "cuda":
        raise ValueError(f"power_sweep_carry_train runs on CPU or CUDA "
                         f"tensors, not {mu_t.device}")
    T, K = mu_t.shape
    D = theta.shape[0]
    P, Pk = sel_k.shape
    check_args("mu_t", {"p_tok": (p_tok, torch.int32, (T,)),
                        "doc_ids": (doc_ids, torch.int32, (T,)),
                        "counts_t": (counts_t, torch.float32, (T, 1)),
                        "mu_t": (mu_t, torch.float32, (T, K)),
                        "theta": (theta, torch.float32, (D, K)),
                        "phi_tot": (phi_tot, torch.float32, (K,)),
                        "phi_eff_wk": (phi_eff_wk, torch.float32,
                                       (phi_eff_wk.shape[0], K)),
                        "sel_w": (sel_w, torch.int32, (P,)),
                        "sel_k": (sel_k, torch.int32, (P, Pk))})
    if Pk > K:
        raise ValueError(f"Pk={Pk} power topics exceed K={K}")
    if runs is None:
        raise ValueError("power_sweep_carry_train needs the tokens' runs by "
                         "word on CUDA (TokenLayout.word_runs)")
    order, starts = runs
    check_args("mu_t", {"order": (order, torch.int32, (T,)),
                        "starts": (starts, torch.int32,
                                   (phi_eff_wk.shape[0] + 1,)),
                        "mu_t": (mu_t, torch.float32, (T, K))})
    dev = mu_t.device
    lib = _lib()
    with torch.cuda.device(dev):
        floats = _train_smem(lib, dev) // 4
        warps = min(_MAX_TRAIN_WARPS, (floats - K) // (2 * max(Pk, 1)))
        if warps < 1:
            raise ValueError(
                f"K={K}, Pk={Pk}: the training kernel takes K + 2 * Pk <= "
                f"{floats} on {dev} (its shared memory)")
        theta_delta = torch.empty_like(theta)
        d_pack = torch.empty((P, Pk), dtype=torch.float32, device=dev)
        r_pack = torch.empty_like(d_pack)
        cd = torch.empty((T, Pk), dtype=torch.float32, device=dev)
        err = lib.power_sweep_carry_train(
            p_tok.data_ptr(), doc_ids.data_ptr(), counts_t.data_ptr(),
            mu_t.data_ptr(), theta.data_ptr(), phi_tot.data_ptr(),
            phi_eff_wk.data_ptr(), sel_w.data_ptr(), sel_k.data_ptr(),
            order.data_ptr(), starts.data_ptr(), cd.data_ptr(),
            theta_delta.data_ptr(), d_pack.data_ptr(), r_pack.data_ptr(),
            T, D, K, P, Pk, float(alpha), float(beta), float(wbeta), warps,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "power_sweep_carry_train kernel launch")
    power_sweep_carry_train.launches += 1
    return mu_t, theta_delta, d_pack, r_pack


power_sweep_carry_train.launches = 0
