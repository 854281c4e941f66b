"""The carry-resident fold-in sweep: its CUDA kernel's wrapper and its plain
PyTorch version.

`power_sweep_carry` is the port's counterpart of the JAX package's
``kernels/power_sweep/ops.py::power_sweep_carry``, without the TPU tile
padding.  Which code runs is decided by the device of the tensors: on a
CUDA tensor it launches the hand-written kernel
(``csrc/power_sweep_carry.cu``) and raises if the kernel cannot build or
launch; on a CPU tensor it runs `power_sweep_carry_plain`.

The TPU side chooses between a full-K kernel and a K-blocked kernel by
whether the row table fits VMEM (``core/sweep_dispatch.py``).  The CUDA
kernel keeps the phi row table in HBM and reads each token's row by
index, so there is no such choice here; the cost model for the training
sweep belongs to the training slice.

The kernel ports the serving mode (``update_phi=False``).  The training
mode (mask-row gather and the [P, K] delta/residual accumulation) exists
here only as the plain version; on a CUDA tensor it raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SOURCE = "power_sweep_carry"
_MAX_WARPS = 8
_smem_optin: dict[int, int] = {}   # device index -> usable shared memory


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.power_sweep_carry_serve
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 9 + [i32] * 5 + [f32] * 3 + [i32, ptr]
        fn.restype = ctypes.c_int
        lib.power_sweep_carry_error_string.argtypes = [ctypes.c_int]
        lib.power_sweep_carry_error_string.restype = ctypes.c_char_p
        lib.power_sweep_carry_configure.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.power_sweep_carry_configure.restype = ctypes.c_int
    return lib


def power_sweep_carry_plain(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                            phi_rows, mask_rows, *, alpha: float,
                            beta: float, wbeta: float, update_phi: bool,
                            n_guard: int):
    """The sweep in plain PyTorch ops: the counterpart of the JAX package's
    ``kernels/power_sweep/ref.py::power_sweep_carry_ref``.

    Serving mode (``update_phi=False``): a token is active when its row id
    is not ``n_guard`` and lies in ``[0, phi_rows.shape[0])``; ``mask_rows``
    is ignored.  Training mode: ``phi_rows``/``mask_rows`` are the
    reference's [P+1, K] tables with the guard row last, ``n_guard = P``.
    ``mu_t`` is overwritten with the new messages and returned as
    ``mu_new``.  Returns (mu_new [T, K], theta_delta [D, K], d_rows [P, K],
    r_rows [P, K], rdoc [D]); the rows are [0, K] in serving mode and rdoc
    is zeros in training mode.
    """
    T, K = mu_t.shape
    D = theta.shape[0]
    p = p_tok.long()
    doc = doc_ids.long()
    n_rows = phi_rows.shape[0]
    valid = (p >= 0) & (p < n_rows)
    phi_tok = phi_rows[p.clamp(0, n_rows - 1)]
    if update_phi:
        m_tok = mask_rows[p.clamp(0, n_rows - 1)] * valid[:, None]
    else:
        m_tok = (valid & (p != n_guard)).to(mu_t.dtype)[:, None]
    self_c = counts_t * mu_t
    th = theta[doc] - self_c + alpha
    if update_phi:
        ph = phi_tok - self_c + beta
        pt = phi_tot[None, :] - self_c + wbeta
    else:
        ph = phi_tok + beta
        pt = phi_tot[None, :] + wbeta
    u = th * ph / pt * m_tok
    mass = torch.sum(mu_t * m_tok, dim=-1, keepdim=True)
    denom = torch.sum(u, dim=-1, keepdim=True).clamp_min(1e-30)
    mu_new = torch.where(m_tok > 0, u * (mass / denom), mu_t)
    cd = counts_t * (mu_new - mu_t)
    theta_delta = torch.zeros_like(theta).index_add_(0, doc, cd)
    if update_phi:
        sel = p < n_guard
        rows = torch.zeros((n_guard, K), dtype=mu_t.dtype, device=mu_t.device)
        d_rows = rows.index_add(0, p[sel], cd[sel])
        r_rows = rows.index_add(0, p[sel], cd[sel].abs())
        rdoc = torch.zeros((D,), dtype=mu_t.dtype, device=mu_t.device)
    else:
        d_rows = r_rows = mu_t.new_zeros((0, K))
        rdoc = torch.zeros((D,), dtype=mu_t.dtype, device=mu_t.device
                           ).index_add_(0, doc, cd.abs().sum(dim=1))
    mu_t.copy_(mu_new)
    return mu_t, theta_delta, d_rows, r_rows, rdoc


def _check_cuda_args(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                     phi_rows):
    T, K = mu_t.shape
    D = theta.shape[0]
    want = {"p_tok": (p_tok, torch.int32, (T,)),
            "doc_ids": (doc_ids, torch.int32, (T,)),
            "counts_t": (counts_t, torch.float32, (T, 1)),
            "mu_t": (mu_t, torch.float32, (T, K)),
            "theta": (theta, torch.float32, (D, K)),
            "phi_tot": (phi_tot, torch.float32, (K,)),
            "phi_rows": (phi_rows, torch.float32, (phi_rows.shape[0], K))}
    for name, (x, dtype, shape) in want.items():
        if x.device != mu_t.device:
            raise ValueError(f"{name} is on {x.device}, mu_t on {mu_t.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T * K >= 2 ** 31 or phi_rows.shape[0] >= 2 ** 31:
        raise ValueError(f"T*K={T * K} exceeds the kernel's int32 indexing")


def _warps(lib: ctypes.CDLL, K: int, device: torch.device) -> int:
    """Warps per CTA: as many as fit one [K] shared-memory row each beside
    the theta and phi_tot rows, at most eight.  The first call on a device
    lets the kernel use all the dynamic shared memory a block may opt in to
    there; it must run with that device current."""
    smem = _smem_optin.get(device.index)
    if smem is None:
        got = ctypes.c_int(0)
        err = lib.power_sweep_carry_configure(ctypes.byref(got))
        if err:
            msg = lib.power_sweep_carry_error_string(err).decode()
            raise RuntimeError(f"power_sweep_carry could not be configured "
                               f"on {device}: CUDA error {err} ({msg})")
        smem = _smem_optin[device.index] = got.value
    warps = min(_MAX_WARPS, smem // (4 * K) - 2)
    if warps < 1:
        raise ValueError(f"K={K} needs more shared memory per CTA than the "
                         f"card's {smem} bytes")
    return warps


def power_sweep_carry(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                      phi_rows, mask_rows, *, alpha: float, beta: float,
                      wbeta: float, update_phi: bool, n_guard: int):
    """One carry-resident sweep over the token-major [T, K] messages.

    p_tok [T] int32 (the row of ``phi_rows`` each token reads; ``n_guard``
    freezes it); doc_ids [T] int32, non-decreasing (tokens are
    doc-contiguous, as ``MiniBatch.token_layout`` builds them); counts_t
    [T, 1]; mu_t [T, K]; theta [D, K]; phi_tot [K]; phi_rows [W', K] — on
    the serving path the normalized phi with no guard row appended, and
    ``n_guard = W'``.  Serving uses ``beta = 0``, ``phi_tot = 0`` and
    ``wbeta = 1``.  ``mu_t`` is updated IN PLACE and returned as mu_new.
    Returns (mu_new, theta_delta [D, K], d_rows, r_rows, rdoc [D]) as
    `power_sweep_carry_plain` documents.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel, counted in ``power_sweep_carry.launches``.
    """
    if mu_t.device.type == "cpu":
        return power_sweep_carry_plain(
            p_tok, doc_ids, counts_t, mu_t, theta, phi_tot, phi_rows,
            mask_rows, alpha=alpha, beta=beta, wbeta=wbeta,
            update_phi=update_phi, n_guard=n_guard)
    if mu_t.device.type != "cuda":
        raise ValueError(f"power_sweep_carry runs on CPU or CUDA tensors, "
                         f"not {mu_t.device}")
    if update_phi:
        raise NotImplementedError(
            "power_sweep_carry(update_phi=True) has no CUDA kernel yet: the "
            "training mode is ported with the training slice (ROADMAP "
            "Queue 2, rows 3 and 4)")
    _check_cuda_args(p_tok, doc_ids, counts_t, mu_t, theta, phi_tot,
                     phi_rows)
    T, K = mu_t.shape
    D = theta.shape[0]
    theta_delta = torch.empty_like(theta)
    rdoc = torch.empty((D,), dtype=torch.float32, device=mu_t.device)
    lib = _lib()
    with torch.cuda.device(mu_t.device):
        err = lib.power_sweep_carry_serve(
            p_tok.data_ptr(), doc_ids.data_ptr(), counts_t.data_ptr(),
            mu_t.data_ptr(), theta.data_ptr(), phi_tot.data_ptr(),
            phi_rows.data_ptr(), theta_delta.data_ptr(), rdoc.data_ptr(),
            T, D, K, phi_rows.shape[0], int(n_guard), float(alpha),
            float(beta), float(wbeta), _warps(lib, K, mu_t.device),
            torch.cuda.current_stream(mu_t.device).cuda_stream)
    if err:
        msg = lib.power_sweep_carry_error_string(err).decode()
        raise RuntimeError(f"power_sweep_carry kernel launch failed: "
                           f"CUDA error {err} ({msg})")
    power_sweep_carry.launches += 1
    empty = mu_t.new_zeros((0, K))
    return mu_t, theta_delta, empty, empty, rdoc


power_sweep_carry.launches = 0
