"""Checkpoints in the JAX package's on-disk format (the serving half of
``repro.dist.checkpoint``).

One directory per step::

    <dir>/step_0000010/
        manifest.json    # per-leaf key path ("['state']['phi_acc']"),
                         # shape, dtype name + the extra dict
        data.npz         # raw little-endian bytes per leaf, as uint8

so phi and the other array leaves (``phi_acc``, ``m``) written by either
package restore in the other.  ``state/rng`` does not cross: the port
writes a torch generator state there, where the reference writes a JAX
PRNG key, so a training resume across packages takes a fresh seed or
injected inits.  Leaves are ordered as ``jax.tree_util`` flattens a dict
of dicts: by sorted key.
bfloat16 leaves are decoded from their raw bytes with torch, so nothing
here needs ``ml_dtypes``.  Template-driven ``restore`` and the elastic
row reshard come with the training slice.
"""

from __future__ import annotations

import json
import os
import shutil
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


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{step:07d}")


def _itemsize(name: str) -> int:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {name!r}")
    return torch.empty((), dtype=_TORCH_DTYPES[name]).element_size()


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def _raw_leaf(leaf) -> Tuple[np.ndarray, List[int], str]:
    """(uint8 bytes, shape, dtype name) of a tensor, ndarray or scalar."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))
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
    final = _step_dir(directory, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for s in sorted(_all_steps(directory))[:-_RETAIN]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
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
    path = _step_dir(directory, step)
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
                leaf: str = "phi_acc", dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any], int]:
    """Load the one leaf whose key path ends in ``leaf`` as a CPU tensor,
    shape and dtype from the manifest (``dtype`` casts it).  Returns
    (tensor, extra, step); raises ``FileNotFoundError`` when the directory
    holds no complete checkpoint and ``ValueError`` when the leaf is
    missing or ambiguous."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {directory!r} — train one "
                f"first (launch.lda_train --ckpt-dir)")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    hits = [(i, rec) for i, rec in enumerate(manifest["leaves"])
            if rec["key"].endswith(f"['{leaf}']")]
    if len(hits) != 1:
        raise ValueError(
            f"checkpoint at {path} has {len(hits)} leaves matching "
            f"{leaf!r}: {[r['key'] for _, r in hits]}")
    i, rec = hits[0]
    if rec["dtype"] not in _TORCH_DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {rec['dtype']!r}")
    with np.load(os.path.join(path, "data.npz")) as data:
        raw = data[f"leaf_{i}"]
    arr = torch.from_numpy(raw).view(_TORCH_DTYPES[rec["dtype"]]).reshape(
        tuple(rec["shape"]))
    if dtype is not None and arr.dtype != dtype:
        arr = arr.to(dtype)
    return arr, manifest.get("extra", {}), int(manifest["step"])
