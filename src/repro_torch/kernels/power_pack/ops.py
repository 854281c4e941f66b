"""The power-submatrix row scatter-add: its CUDA kernel's wrapper and its
plain PyTorch version.

`scatter_add_rows` is the port's counterpart of the JAX package's
``kernels/power_pack/ops.py::scatter_add_rows`` (the Pallas kernel
``scatter_add_rows_pallas``), without the TPU tile padding.  It updates
``mat`` IN PLACE, where the reference returns a new array.  On a CUDA
tensor it launches the hand-written kernel (``csrc/power_pack.cu``) and
raises if the kernel cannot build or launch; on a CPU tensor it runs
`scatter_add_rows_plain`.  The gather ``pack_rows_pallas`` is not on the
training slice's path and is not ported yet (ROADMAP Queue 2, row 5).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SOURCE = "power_pack"


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.scatter_add_rows
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
        lib.power_pack_error_string.argtypes = [ctypes.c_int]
        lib.power_pack_error_string.restype = ctypes.c_char_p
    return lib


def scatter_add_rows_plain(mat, sel_w, sel_k, vals):
    """``mat[sel_w[p], sel_k[p, j]] += vals[p, j]`` in plain PyTorch ops
    (one flat ``index_add_``), IN PLACE; pairs outside ``mat`` are dropped,
    as the reference's scatter drops them.  Returns ``mat``."""
    W, K = mat.shape
    w = sel_w.long()[:, None].expand(sel_k.shape)
    k = sel_k.long()
    keep = (w >= 0) & (w < W) & (k >= 0) & (k < K)
    flat = torch.where(keep, w * K + k, 0).reshape(-1)
    mat.view(-1).index_add_(0, flat,
                            torch.where(keep, vals, 0.0).reshape(-1))
    return mat


def _check_cuda_args(mat, sel_w, sel_k, vals):
    P, Pk = sel_k.shape
    want = {"mat": (mat, torch.float32, tuple(mat.shape)),
            "sel_w": (sel_w, torch.int32, (P,)),
            "sel_k": (sel_k, torch.int32, (P, Pk)),
            "vals": (vals, torch.float32, (P, Pk))}
    if mat.dim() != 2:
        raise ValueError(f"mat must be [W, K], got shape {tuple(mat.shape)}")
    for name, (x, dtype, shape) in want.items():
        if x.device != mat.device:
            raise ValueError(f"{name} is on {x.device}, mat on {mat.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def scatter_add_rows(mat, sel_w, sel_k, vals):
    """``mat[sel_w[p], sel_k[p, j]] += vals[p, j]`` IN PLACE; returns mat.

    mat [W, K] float32; sel_w [P] int32; sel_k [P, Pk] int32; vals [P, Pk]
    float32.  Repeated (row, column) pairs all add; pairs outside ``mat``
    are dropped.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, counted in ``scatter_add_rows.launches``.  The
    kernel adds with atomics, so repeated pairs may sum in any order.
    """
    if mat.device.type == "cpu":
        return scatter_add_rows_plain(mat, sel_w, sel_k, vals)
    if mat.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on CPU or CUDA tensors, not "
                         f"{mat.device}")
    _check_cuda_args(mat, sel_w, sel_k, vals)
    (W, K), (P, Pk) = mat.shape, sel_k.shape
    lib = _lib()
    with torch.cuda.device(mat.device):
        err = lib.scatter_add_rows(
            mat.data_ptr(), sel_w.data_ptr(), sel_k.data_ptr(),
            vals.data_ptr(), P, Pk, W, K,
            torch.cuda.current_stream(mat.device).cuda_stream)
    if err:
        msg = lib.power_pack_error_string(err).decode()
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    scatter_add_rows.launches += 1
    return mat


scatter_add_rows.launches = 0
