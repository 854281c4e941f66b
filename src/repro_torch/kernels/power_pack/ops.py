"""The power-submatrix row gather and row scatter-add: their CUDA kernels'
wrappers and their plain PyTorch versions.

`pack_rows` and `scatter_add_rows` are the port's counterparts of the JAX
package's ``kernels/power_pack/ops.py::pack_rows`` and
``::scatter_add_rows`` (the Pallas kernels ``pack_rows_pallas`` and
``scatter_add_rows_pallas``), without the TPU tile padding.
`scatter_add_rows` updates ``mat`` IN PLACE, where the reference returns a
new array.  ``sel_w`` may repeat a row: a live-W power selection points
every dead slot at one guard row, all zeros in phi, with zero values to
add.  `pack_rows` gathers such a row again for each slot; `scatter_add_rows`
adds each slot's values with atomics in whatever order they land, which
changes no bit when they are exact zeros.  On a CUDA tensor each launches its hand-written kernel
(``csrc/power_pack.cu``) and raises if the kernel cannot build or launch;
on a CPU tensor each runs its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check_args, launcher

_SOURCE = "power_pack"


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


# the kernels take P, Pk, W and K as C ints; they index with 64-bit
# offsets, so a matrix of 2^31 elements or more is fine, a side of 2^31 is
# not
_MAX_SIDE = 2 ** 31


def _check_cuda_args(mat, sel_w, sel_k, vals=None):
    if mat.dim() != 2:
        raise ValueError(f"mat must be [W, K], got shape {tuple(mat.shape)}")
    P, Pk = sel_k.shape
    for name, n in (("P", P), ("Pk", Pk), ("W", mat.shape[0]),
                    ("K", mat.shape[1])):
        if n >= _MAX_SIDE:
            raise ValueError(f"{name} = {n} is past the power-pack kernels' "
                             f"int argument (< 2^31)")
    want = {"mat": (mat, torch.float32, tuple(mat.shape)),
            "sel_w": (sel_w, torch.int32, (P,)),
            "sel_k": (sel_k, torch.int32, (P, Pk))}
    if vals is not None:
        want["vals"] = (vals, torch.float32, (P, Pk))
    check_args("mat", want)


@launcher(_SOURCE, "mat", pack_rows_plain)
def pack_rows(kernel, stream, mat, sel_w, sel_k):
    """``out[p, j] = mat[sel_w[p], sel_k[p, j]]``: the [P, Pk] power
    submatrix of ``mat``, a new tensor.

    mat [W, K] float32; sel_w [P] int32; sel_k [P, Pk] int32.  Pairs outside
    ``mat`` pack to 0.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, counted as ``pack_rows``.  Exact: each output is
    one element of ``mat``.
    """
    _check_cuda_args(mat, sel_w, sel_k)
    (W, K), (P, Pk) = mat.shape, sel_k.shape
    out = torch.empty((P, Pk), dtype=torch.float32, device=mat.device)
    kernel.launch(kernel.lib.pack_rows, mat.data_ptr(), sel_w.data_ptr(),
                  sel_k.data_ptr(), out.data_ptr(), P, Pk, W, K, stream)
    return out


@launcher(_SOURCE, "mat", scatter_add_rows_plain)
def scatter_add_rows(kernel, stream, mat, sel_w, sel_k, vals):
    """``mat[sel_w[p], sel_k[p, j]] += vals[p, j]`` IN PLACE; returns mat.

    mat [W, K] float32; sel_w [P] int32; sel_k [P, Pk] int32; vals [P, Pk]
    float32.  Repeated (row, column) pairs all add; pairs outside ``mat``
    are dropped.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, counted as ``scatter_add_rows``.  The kernel adds
    with atomics, so repeated pairs may sum in any order.
    """
    _check_cuda_args(mat, sel_w, sel_k, vals)
    (W, K), (P, Pk) = mat.shape, sel_k.shape
    kernel.launch(kernel.lib.scatter_add_rows, mat.data_ptr(),
                  sel_w.data_ptr(), sel_k.data_ptr(), vals.data_ptr(), P, Pk,
                  W, K, stream)
    return mat
