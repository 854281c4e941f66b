"""Checkpoints in the JAX package's on-disk format: the counterpart of
``repro.dist.checkpoint``.

One directory per step::

    <dir>/step_0000010/
        manifest.json    # per-leaf key path ("['state']['phi_acc']"),
                         # shape, dtype name + the extra dict
        data.npz         # raw little-endian bytes per leaf, as uint8

so phi and the other array leaves (``phi_acc``, ``m``) written by either
package restore in the other.  ``state/rng`` does not cross: the port
writes a torch generator state there, where the reference writes a JAX
PRNG key, so a training resume across packages takes a fresh seed or
injected inits (the port's driver refuses a JAX-written ``rng``).  Leaves
are ordered as ``jax.tree_util`` flattens a dict of dicts: by sorted key.
bfloat16 leaves are decoded from their raw bytes with torch, so nothing
here needs ``ml_dtypes``.

Writes are atomic (staged, then renamed into place).  Restore is
template-driven (`restore`): the caller gives a tree of like-shaped
tensors or arrays and gets the same structure back, each leaf on its
template tensor's device; a key, shape or dtype mismatch raises
``ValueError``, except where the caller allows a grown row count
(``grow_rows``), a dtype cast (``cast_dtypes``, the float32/bfloat16
switch of phi_acc at a restore fence) or a fenced row remap
(``row_remaps``), all through `_resize_rows`, the one place rows are
validated.  `restore_latest` tries the retained steps newest first and
falls back past a corrupt one (`verify_step`) with a warning; a template
mismatch on an intact step still raises.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_RETAIN = 3
_PREFIX = "step_"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "uint32": torch.uint32, "uint16": torch.uint16, "uint64": torch.uint64,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def step_dir(directory: str, step: int) -> str:
    """The directory of checkpoint ``step`` under ``directory``."""
    return os.path.join(directory, f"{_PREFIX}{step:07d}")


def _itemsize(name: str) -> int:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {name!r}")
    return torch.empty((), dtype=_TORCH_DTYPES[name]).element_size()


def _resize_rows(arr: torch.Tensor, rows: int, what: str,
                 row_remap=None) -> torch.Tensor:
    """Elastic W-reshard of one leaf: the one place row validation lives
    (`restore`, `restore_latest` and `restore_phi` all route through it).

    Growing zero-pads axis 0 up to ``rows`` (the pad rows are guard rows).
    Shrinking or reordering needs ``row_remap``, a fenced compaction remap
    (``remap[i]`` is row i's new row, -1 for a reclaimed row): surviving
    rows land at their remapped index, dead and vacated rows come back as
    zero rows.  Without a remap a shrink raises: cutting rows would drop
    live statistics."""
    if row_remap is not None:
        remap = torch.as_tensor(np.asarray(row_remap, np.int64))
        out = torch.zeros((rows,) + tuple(arr.shape[1:]), dtype=arr.dtype)
        src = arr[:remap.shape[0]]
        ok = (remap >= 0) & (remap < rows)
        out[remap[ok]] = src[ok]
        return out
    if rows < arr.shape[0]:
        raise ValueError(
            f"cannot shrink {what} from {arr.shape[0]} to {rows} rows "
            f"without a compaction remap — vocab eviction is supported "
            f"only via the checkpoint-fenced remap path (pass row_remap "
            f"from the fence manifest)")
    if rows == arr.shape[0]:
        return arr
    pad = torch.zeros((rows - arr.shape[0],) + tuple(arr.shape[1:]),
                      dtype=arr.dtype)
    return torch.cat([arr, pad], dim=0)


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def _unflatten(tree, leaves: List[Any]):
    """``tree``'s dict structure with its leaves replaced, in `_flatten`'s
    order, by ``leaves`` (consumed from the front)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return leaves.pop(0)


def _leaf_spec(leaf) -> Tuple[Tuple[int, ...], Optional[str]]:
    """(shape, dtype name or None) of a template leaf: a tensor, an array,
    a numpy scalar, or anything with a ``shape`` and a ``dtype``."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), _NAMES.get(leaf.dtype, str(leaf.dtype))
    dtype = getattr(leaf, "dtype", None)
    return (tuple(np.shape(leaf)),
            None if dtype is None else np.dtype(dtype).name)


def _decode(raw: np.ndarray, rec: Dict[str, Any]) -> torch.Tensor:
    """A leaf's raw bytes as a CPU tensor of its manifest shape and dtype."""
    if rec["dtype"] not in _TORCH_DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {rec['dtype']!r}")
    return torch.from_numpy(np.ascontiguousarray(raw)).view(
        _TORCH_DTYPES[rec["dtype"]]).reshape(tuple(rec["shape"]))


def _raw_leaf(leaf) -> Tuple[np.ndarray, List[int], str]:
    """(uint8 bytes, shape, dtype name) of a tensor, ndarray or scalar."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))   # a 0-d leaf stays 0-d
    t = leaf.detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"unsupported leaf dtype {t.dtype}")
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return raw, list(t.shape), _NAMES[t.dtype]


def save(directory: str, step: int, trees: Dict[str, Any],
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Persist ``trees`` (nested dicts of tensors or arrays) and a JSON-able
    ``extra`` dict; staged in a temporary directory and renamed into place,
    keeping the newest three steps."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"step": int(step), "extra": extra or {}, "leaves": []}
    payload = {}
    for i, (key, leaf) in enumerate(_flatten(trees)):
        raw, shape, name = _raw_leaf(leaf)
        manifest["leaves"].append({"key": key, "shape": shape,
                                   "dtype": name})
        payload[f"leaf_{i}"] = raw
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "data.npz"), **payload)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    final = step_dir(directory, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for s in sorted(_all_steps(directory))[:-_RETAIN]:
        shutil.rmtree(step_dir(directory, s), ignore_errors=True)
    return final


def _all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX):
            continue
        if not os.path.exists(os.path.join(directory, name, "manifest.json")):
            continue
        try:
            out.append(int(name[len(_PREFIX):]))
        except ValueError:
            continue
    return out


def latest_step(directory: str) -> Optional[int]:
    """Newest complete checkpoint step in ``directory``, or None."""
    steps = _all_steps(directory)
    return max(steps) if steps else None


def verify_step(directory: str, step: int) -> Optional[str]:
    """None when the step is intact, else what is wrong with it: an
    unreadable manifest or data.npz, a missing leaf, or a leaf whose byte
    count disagrees with its manifest shape and dtype."""
    path = step_dir(directory, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "data.npz")) as data:
            for i, rec in enumerate(manifest["leaves"]):
                want = int(np.prod(rec["shape"], dtype=np.int64)) \
                    * _itemsize(rec["dtype"])
                if f"leaf_{i}" not in data:
                    return f"data.npz is missing leaf_{i} ({rec['key']})"
                got = int(data[f"leaf_{i}"].nbytes)
                if got != want:
                    return (f"leaf_{i} ({rec['key']}) holds {got} bytes, "
                            f"manifest says {want} — torn write?")
    except Exception as e:  # noqa: BLE001 — any decode failure IS the answer
        return f"{type(e).__name__}: {e}"
    return None


def restore_phi(directory: str, step: Optional[int] = None,
                leaf: str = "phi_acc", dtype: Optional[torch.dtype] = None,
                w_cap: Optional[int] = None, row_remap=None
                ) -> Tuple[torch.Tensor, Dict[str, Any], int]:
    """Load the one leaf whose key path ends in ``leaf`` as a CPU tensor,
    shape and dtype from the manifest.  ``w_cap`` resizes its row axis
    through `_resize_rows` (zero-padded up; a shrink needs ``row_remap``,
    the fenced compaction remap); ``dtype`` casts it (a bf16-trained phi
    serves in float32 and back).  Returns (tensor, extra, step); raises
    ``FileNotFoundError`` when the directory holds no complete checkpoint
    and ``ValueError`` when the leaf is missing or ambiguous."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {directory!r} — train one "
                f"first (launch.lda_train --ckpt-dir)")
    path = step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    hits = [(i, rec) for i, rec in enumerate(manifest["leaves"])
            if rec["key"].endswith(f"['{leaf}']")]
    if len(hits) != 1:
        raise ValueError(
            f"checkpoint at {path} has {len(hits)} leaves matching "
            f"{leaf!r}: {[r['key'] for _, r in hits]}")
    i, rec = hits[0]
    with np.load(os.path.join(path, "data.npz")) as data:
        arr = _decode(data[f"leaf_{i}"], rec)
    if w_cap is not None:
        arr = _resize_rows(arr, int(w_cap), repr(leaf), row_remap=row_remap)
    if dtype is not None and arr.dtype != dtype:
        arr = arr.to(dtype)
    return arr, manifest.get("extra", {}), int(manifest["step"])


def peek_extra(directory: str, step: Optional[int] = None
               ) -> Optional[Tuple[Dict[str, Any], int]]:
    """Read only the manifest's ``extra`` dict (no array bytes), or None.

    Picking the step (``step=None``) skips a step whose manifest does not
    parse, with a ``RuntimeWarning``, as the restore that follows falls
    back past it; an explicit ``step`` raises."""
    if step is None:
        for s in sorted(_all_steps(directory), reverse=True):
            try:
                with open(os.path.join(step_dir(directory, s),
                                       "manifest.json")) as f:
                    manifest = json.load(f)
            except Exception as e:  # noqa: BLE001
                warnings.warn(
                    f"manifest of {step_dir(directory, s)} is unreadable "
                    f"({type(e).__name__}: {e}); peeking the previous "
                    f"retained step", RuntimeWarning, stacklevel=2)
                continue
            return manifest.get("extra", {}), int(manifest["step"])
        return None
    with open(os.path.join(step_dir(directory, step), "manifest.json")) as f:
        manifest = json.load(f)
    return manifest.get("extra", {}), int(manifest["step"])


def restore_latest(directory: str, template: Dict[str, Any],
                   grow_rows: Tuple[str, ...] = (),
                   cast_dtypes: Tuple[str, ...] = (),
                   row_remaps: Optional[Dict[str, Any]] = None
                   ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any], int]]:
    """Restore the newest intact checkpoint into ``template``'s structure,
    or return None when there is none.

    Retained steps are tried newest first through `verify_step`: a corrupt
    step (torn write, truncation) warns (``RuntimeWarning``) and the next
    older one is tried.  Only corruption falls back; a template mismatch on
    an intact step raises ``ValueError``.  ``grow_rows``, ``cast_dtypes``
    and ``row_remaps`` as in `restore`."""
    skipped = 0
    for step in sorted(_all_steps(directory), reverse=True):
        bad = verify_step(directory, step)
        if bad is not None:
            warnings.warn(
                f"checkpoint {step_dir(directory, step)} is corrupt "
                f"({bad}); falling back to the previous retained step",
                RuntimeWarning, stacklevel=2)
            skipped += 1
            continue
        if skipped:
            warnings.warn(
                f"resuming from step {step} after skipping {skipped} "
                f"corrupt newer checkpoint(s) — up to that many save "
                f"intervals of work will be recomputed",
                RuntimeWarning, stacklevel=2)
        return restore(directory, step, template, grow_rows=grow_rows,
                       cast_dtypes=cast_dtypes, row_remaps=row_remaps)
    return None


def restore(directory: str, step: int, template: Dict[str, Any], *,
            grow_rows: Tuple[str, ...] = (),
            cast_dtypes: Tuple[str, ...] = (),
            row_remaps: Optional[Dict[str, Any]] = None
            ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """Load the checkpoint at ``step`` into the structure of ``template``.

    ``template`` leaves (tensors, arrays or numpy scalars) give structure,
    shape and dtype only; their values are never read.  Each restored leaf
    is a tensor on its template tensor's device (the CPU for a non-tensor
    template leaf).  ``grow_rows`` names leaves (by key-path suffix, e.g.
    ``"phi_acc"``) whose axis 0 may be smaller in the checkpoint than in
    the template: the saved rows are zero-padded up.  ``cast_dtypes`` (same
    matching) allows a dtype mismatch for the named leaves: the saved leaf
    is cast to the template's dtype (phi_acc between float32 and bfloat16
    at a restore fence).  ``row_remaps`` maps leaf suffixes to a fenced
    compaction remap: the named leaves may then shrink or permute their
    rows.  Any other mismatch, a remap-less shrink included, raises
    ``ValueError``.  Returns (trees, extra, step).
    """
    path = step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(template)
    recs = manifest["leaves"]
    if len(recs) != len(flat):
        raise ValueError(f"checkpoint leaf count mismatch: saved {len(recs)} "
                         f"!= template {len(flat)}")

    def named(key, names):
        return any(key.endswith(f"['{name}']") for name in names)

    leaves = []
    with np.load(os.path.join(path, "data.npz")) as data:
        for i, ((key, leaf), rec) in enumerate(zip(flat, recs)):
            if rec["key"] != key:
                raise ValueError(f"checkpoint key mismatch at leaf {i}: "
                                 f"saved {rec['key']!r} != template {key!r}")
            shape = tuple(rec["shape"])
            want, want_dtype = _leaf_spec(leaf)
            remap = next((v for name, v in (row_remaps or {}).items()
                          if key.endswith(f"['{name}']")), None)
            rows_ok = len(shape) == len(want) and shape[1:] == want[1:]
            growable = (named(key, grow_rows) and rows_ok
                        and shape[0] <= want[0])
            if shape != want and not growable and not (remap is not None
                                                       and rows_ok):
                raise ValueError(f"shape mismatch for {key}: saved {shape} "
                                 f"!= template {want}")
            castable = want_dtype is not None and named(key, cast_dtypes)
            if (want_dtype is not None and not castable
                    and rec["dtype"] != want_dtype):
                raise ValueError(f"dtype mismatch for {key}: saved "
                                 f"{rec['dtype']} != template {want_dtype}")
            arr = _decode(data[f"leaf_{i}"], rec)
            if remap is not None or shape != want:   # fenced remap / rung pad
                arr = _resize_rows(arr, want[0], key, row_remap=remap)
            if castable and rec["dtype"] != want_dtype:
                arr = arr.to(_TORCH_DTYPES[want_dtype])
            if isinstance(leaf, torch.Tensor):
                arr = arr.to(leaf.device)
            leaves.append(arr)
    return (_unflatten(template, leaves), manifest.get("extra", {}),
            int(manifest["step"]))
