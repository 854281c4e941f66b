"""The power-submatrix row gather and row scatter-add: their CUDA kernels'
wrappers and their plain PyTorch versions.

`pack_rows` and `scatter_add_rows` are the port's counterparts of the JAX
package's ``kernels/power_pack/ops.py::pack_rows`` and
``::scatter_add_rows`` (the Pallas kernels ``pack_rows_pallas`` and
``scatter_add_rows_pallas``), without the TPU tile padding.
`scatter_add_rows` updates ``mat`` IN PLACE, where the reference returns a
new array.  On a CUDA tensor each launches its hand-written kernel
(``csrc/power_pack.cu``) and raises if the kernel cannot build or launch;
on a CPU tensor each runs its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_args

_SOURCE = "power_pack"


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.scatter_add_rows.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.scatter_add_rows, lib.pack_rows):
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            fn.restype = ctypes.c_int
        lib.power_pack_error_string.argtypes = [ctypes.c_int]
        lib.power_pack_error_string.restype = ctypes.c_char_p
    return lib


def _flat_pairs(mat, sel_w, sel_k):
    """The flat index into ``mat`` of each (sel_w[p], sel_k[p, j]) pair
    (0 where the pair lies outside ``mat``) and the mask of pairs inside."""
    W, K = mat.shape
    w = sel_w.long()[:, None].expand(sel_k.shape)
    k = sel_k.long()
    keep = (w >= 0) & (w < W) & (k >= 0) & (k < K)
    return torch.where(keep, w * K + k, 0), keep


def pack_rows_plain(mat, sel_w, sel_k):
    """``out[p, j] = mat[sel_w[p], sel_k[p, j]]`` in plain PyTorch ops (one
    flat gather): a new [P, Pk] tensor; pairs outside ``mat`` pack to 0."""
    flat, keep = _flat_pairs(mat, sel_w, sel_k)
    return torch.where(keep, mat.reshape(-1)[flat], 0.0)


def scatter_add_rows_plain(mat, sel_w, sel_k, vals):
    """``mat[sel_w[p], sel_k[p, j]] += vals[p, j]`` in plain PyTorch ops
    (one flat ``index_add_``), IN PLACE; pairs outside ``mat`` are dropped,
    as the reference's scatter drops them.  Returns ``mat``."""
    flat, keep = _flat_pairs(mat, sel_w, sel_k)
    mat.view(-1).index_add_(0, flat.reshape(-1),
                            torch.where(keep, vals, 0.0).reshape(-1))
    return mat


def _check_cuda_args(mat, sel_w, sel_k, vals=None):
    P, Pk = sel_k.shape
    want = {"mat": (mat, torch.float32, tuple(mat.shape)),
            "sel_w": (sel_w, torch.int32, (P,)),
            "sel_k": (sel_k, torch.int32, (P, Pk))}
    if vals is not None:
        want["vals"] = (vals, torch.float32, (P, Pk))
    if mat.dim() != 2:
        raise ValueError(f"mat must be [W, K], got shape {tuple(mat.shape)}")
    check_args("mat", want)


def pack_rows(mat, sel_w, sel_k):
    """``out[p, j] = mat[sel_w[p], sel_k[p, j]]``: the [P, Pk] power
    submatrix of ``mat``, a new tensor.

    mat [W, K] float32; sel_w [P] int32; sel_k [P, Pk] int32.  Pairs outside
    ``mat`` pack to 0.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, counted in ``pack_rows.launches``.  Exact: each
    output is one element of ``mat``.
    """
    if mat.device.type == "cpu":
        return pack_rows_plain(mat, sel_w, sel_k)
    if mat.device.type != "cuda":
        raise ValueError(f"pack_rows runs on CPU or CUDA tensors, not "
                         f"{mat.device}")
    _check_cuda_args(mat, sel_w, sel_k)
    (W, K), (P, Pk) = mat.shape, sel_k.shape
    out = torch.empty((P, Pk), dtype=torch.float32, device=mat.device)
    lib = _lib()
    with torch.cuda.device(mat.device):
        err = lib.pack_rows(
            mat.data_ptr(), sel_w.data_ptr(), sel_k.data_ptr(),
            out.data_ptr(), P, Pk, W, K,
            torch.cuda.current_stream(mat.device).cuda_stream)
    if err:
        msg = lib.power_pack_error_string(err).decode()
        raise RuntimeError(f"pack_rows kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    pack_rows.launches += 1
    return out


pack_rows.launches = 0


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
