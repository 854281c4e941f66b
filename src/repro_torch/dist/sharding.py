"""Sharding policy (pure metadata; counterpart of ``repro.dist.sharding``).

One name-based rule table maps every parameter leaf to a `PartitionSpec`:
matmul weights are FSDP-sharded on their input dim (``data``) and
tensor-parallel on their output dim (``model``); output projections flip
the pair so the TP all-reduce happens after the second matmul; experts are
expert-parallel over ``model``; norms/biases/gates replicate.  Stacked
layers contribute leading dims that are never sharded: the rule matches
the *trailing* dims, so the same table covers unstacked blocks (zamba2's
shared block), stacks, and doubly-stacked VLM groups.

``validate_specs`` then drops any sharded axis that does not divide the
mesh axis size.  Everything here reads shapes only (meta tensors do), and
a mesh is a ``DeviceMesh`` or any object with ``axis_names`` and a
``shape`` mapping.  `placements` turns a spec into the DTensor placements
of a ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_DP_AXES = ("pod", "data")

# leaf name -> (trailing-dim sharding, under-moe override)
_RULES: Dict[str, Tuple] = {
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    "wo": ("model", "data"),
    "out_proj": ("model", "data"),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wi": ("data", "model"),
    "wg": ("data", "model"),
    "in_proj": ("data", "model"),
    "wdkv": ("data", None),
    "wuk": (None, "model"),
    "wuv": (None, "model"),
    "wr": ("data", None),
}
# experts carry a leading E dim sharded over `model` (EP); d_model stays FSDP
_MOE_RULES: Dict[str, Tuple] = {
    "wi": ("model", "data", None),
    "wg": ("model", "data", None),
    "wo": ("model", None, "data"),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim split over several axes, the first major), or None.  A tuple, so
    it compares equal to the reference's spec entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _path_keys(path) -> Tuple[str, ...]:
    """A tree path (dict keys, list or tuple indices) as strings."""
    return tuple(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over ``tree``, in its own container types."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        vals = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return fn(path, tree)


def _zip_map(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and the tree it mirrors."""
    if _is_spec(specs):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: _zip_map(fn, v, tree[k]) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        vals = [_zip_map(fn, s, t) for s, t in zip(specs, tree)]
        return type(specs)(*vals) if hasattr(specs, "_fields") else \
            type(specs)(vals)
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def spec_for(path_keys: Tuple[str, ...], leaf) -> P:
    """PartitionSpec for one parameter leaf, from its tree path + rank.

    Leading dims beyond the rule's trailing pattern (stack dims) are
    always unsharded; unknown names replicate fully.
    """
    name = path_keys[-1] if path_keys else ""
    parent = path_keys[-2] if len(path_keys) > 1 else ""
    rank = len(_shape(leaf))
    trailing = None
    if parent == "moe" and name in _MOE_RULES:
        trailing = _MOE_RULES[name]
    elif name in _RULES:
        trailing = _RULES[name]
    if trailing is None or rank < len(trailing):
        return P(*([None] * rank))
    lead = rank - len(trailing)
    return P(*([None] * lead), *trailing)


def param_specs(params) -> Any:
    """PartitionSpec tree mirroring a parameter tree (shapes only read)."""
    return _map_with_path(
        lambda path, leaf: spec_for(_path_keys(path), leaf), params)


def _mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names in mesh order, size by name) of a ``DeviceMesh`` or of
    an object with ``axis_names`` and a ``shape`` mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        names = tuple(mesh.mesh_dim_names)
        return names, dict(zip(names, tuple(mesh.shape)))
    return tuple(mesh.axis_names), dict(mesh.shape)


def _dp(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _mesh_axes(mesh)[0] if a in _DP_AXES)


def batch_specs(batch, mesh) -> Any:
    """Input batches shard their leading (batch) dim over the data axes."""
    dp = _dp(mesh)

    def one(_, leaf):
        rank = len(_shape(leaf))
        if rank == 0:
            return P()
        return P(dp, *([None] * (rank - 1)))

    return _map_with_path(one, batch)


# decode-cache leaves have a known trailing rank; the batch dim sits just
# before it (leading dims are stack/group dims, never sharded).
_CACHE_BASE_RANK = {"k": 4, "v": 4, "ckv": 3, "kr": 3,
                    "h": 4, "conv": 3, "mk": 4, "mv": 4}


def cache_pspecs(cache, mesh, cfg=None) -> Any:
    """Decode caches shard their batch dim over the data axes."""
    dp = _dp(mesh)

    def one(path, leaf):
        keys = _path_keys(path)
        name = keys[-1] if keys else ""
        rank = len(_shape(leaf))
        base = _CACHE_BASE_RANK.get(name)
        if base is None or rank < base:
            return P(*([None] * rank))
        spec = [None] * rank
        spec[rank - base] = dp
        return P(*spec)

    return _map_with_path(one, cache)


def phi_serving_spec(mesh, phi) -> P:
    """Serving-time spec for a [W, K] topic-word matrix: topics shard over
    the ``model`` axis when the mesh has one and K divides it, words stay
    replicated (every shard folds in the full vocabulary of its documents,
    the split the training inner loop uses).

    The W axis is never sharded, so the spec stays valid under dynamic
    vocabulary growth: a phi grown to any capacity rung, including the +1
    guard row the serving engine appends, resolves to the same
    ``P(None, 'model')`` with no divisibility constraint on W.  Specs are
    dtype-agnostic: a bfloat16 phi_acc shards as float32 does."""
    spec = P(None, "model" if "model" in _mesh_axes(mesh)[0] else None)
    return validate_specs(spec, phi, mesh)


def _axis_size(mesh, entry) -> int:
    sizes = _mesh_axes(mesh)[1]
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return int(np.prod([sizes[a] for a in axes]))


def validate_specs(specs, tree, mesh) -> Any:
    """Drop every sharded spec axis that does not divide its dim size."""

    def one(spec, leaf):
        shape = _shape(leaf)
        fixed = []
        for i, entry in enumerate(spec):
            if entry is None or i >= len(shape):
                fixed.append(None)
                continue
            size = _axis_size(mesh, entry)
            fixed.append(entry if size and shape[i] % size == 0 else None)
        return P(*fixed)

    return _zip_map(one, specs, tree)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    for each mesh dim, ``Shard(d)`` when tensor dim d names its axis, else
    ``Replicate()``.

    A tuple entry shards one tensor dim over several mesh dims.  JAX
    splits such a dim with the tuple's first axis major; DTensor splits a
    dim that several mesh dims shard in mesh-dim order, the first major.
    The two agree only when the tuple names its axes in mesh order, so a
    tuple in any other order is refused rather than placed differently."""
    from torch.distributed.tensor import Replicate, Shard

    names = _mesh_axes(mesh)[0]
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                                 f"the mesh's {names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            out[i] = Shard(d)
            dims.append(i)
        if dims != sorted(dims):
            raise ValueError(
                f"spec entry {entry} splits dim {d} over mesh axes out of "
                f"the mesh's order {names}: DTensor would split it with "
                f"another axis major than JAX does")
    return out
