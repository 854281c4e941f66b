"""Shared model components: init helpers, norms, RoPE, the loss, and the
param-tree helpers (counterpart of ``repro.models.common``).

Param and cache trees are nested dicts and lists of tensors with the
reference's keys and its stacked leading layer axes, so carrying one across
is a tree map.  ``ShardingCtx`` carries the reference's activation-sharding
hints onto a ``DeviceMesh``: they act on DTensors and leave a plain tensor
as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16


# --------------------------------------------------------------- sharding

@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Activation-sharding hints; no-ops when not ``active`` and on a plain
    (not DTensor) tensor.

    ``batch`` covers the DP axes ('pod', 'data'); ``model`` is TP/EP;
    ``seq`` is the sequence-parallel axis of the residual stream between
    layers (Megatron SP), set to the model axis in training.  ``mesh`` is
    the ``torch.distributed.device_mesh.DeviceMesh`` the hints name axes
    of; the MoE's expert-parallel island (``models/moe.py``) runs over its
    process groups.
    """

    active: bool = False
    batch: Optional[Tuple[str, ...]] = ("data",)
    model: Optional[str] = "model"
    seq: Optional[str] = None
    mesh: Optional[object] = None

    def ct(self, x: torch.Tensor, *spec):
        """``x`` redistributed to the placements ``spec`` names on
        ``mesh`` (the reference's ``with_sharding_constraint``): dims the
        spec leaves out or sets to None are replicated."""
        if not self.active:
            return x
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        from repro_torch.dist.sharding import P, placements

        return x.redistribute(self.mesh, placements(P(*spec), self.mesh))

    def ct_seq(self, x: torch.Tensor):
        """Pin a [B, S, D] projection output to the sequence-parallel
        layout before the residual add, so its row-parallel partial sum
        becomes a reduce-scatter rather than an all-reduce."""
        if not self.active or self.seq is None:
            return x
        return self.ct(x, self.batch, self.seq, None)


NULL_CTX = ShardingCtx(active=False)


# ------------------------------------------------------------------ trees

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of ``tree``, dict keys in sorted order (the order
    in which JAX flattens a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_unflatten(tree, leaves):
    """``tree``'s structure, in its own container types, with its leaves
    replaced, in `tree_leaves`' order, by ``leaves``
    (``jax.tree.unflatten``'s counterpart)."""
    return _unflatten(tree, iter(leaves))


def _unflatten(t, it):
    # a module-level recursion: a nested one would close over itself, and
    # that cycle would hold ``leaves`` until the garbage collector ran
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        vals = [_unflatten(v, it) for v in t]
        return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
    return next(it)


def tree_stack(trees):
    """Stack same-shaped trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_at(tree, i: int):
    """Slice ``i`` of the leading (layer) axis of every leaf: views, so a
    write into a cache slice lands in the stacked cache."""
    return tree_map(lambda a: a[i], tree)


# ----------------------------------------------------------------- params

class Draw:
    """Where a param tree's leaves are drawn: from a ``torch.Generator``
    seeded with ``seed`` on ``device``, each leaf in its final dtype, one
    leaf at a time; on the ``meta`` device only shapes and dtypes are made
    (no data, no draws)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.gen = (None if self.device.type == "meta" else
                    torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape, scale: float, dtype=PARAM_DTYPE) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        return (torch.randn(shape, generator=self.gen, device=self.device,
                            dtype=torch.float32) * scale).to(dtype)

    def full(self, shape, value: float, dtype=COMPUTE_DTYPE) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def dense_init(draw: Draw, d_in: int, d_out: int, dtype=PARAM_DTYPE,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return draw.normal((d_in, d_out), scale, dtype)


def embed_init(draw: Draw, vocab: int, d: int, dtype=PARAM_DTYPE):
    return draw.normal((vocab, d), 0.02, dtype)


def stack_init(draw: Draw, n: int, init_fn: Callable[[], Any]):
    """``init_fn()`` drawn ``n`` times into a tree with a leading layer
    axis, layer by layer into the stacked leaves (no second copy)."""
    first = init_fn()
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        layer = first if i == 0 else init_fn()
        if draw.gen is not None:
            tree_map(lambda dst, src: dst.copy_(src), tree_at(out, i), layer)
    return out


# ------------------------------------------------------------------ norms

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


# ------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(factor) + 1`` (1 when
    the context is not stretched)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, theta: float, yarn) -> Tuple[int, int]:
    """The dims (of the ``dim / 2`` frequencies) where YaRN's ramp starts
    and ends: those that turn ``beta_fast`` and ``beta_slow`` times over
    the original context, floored and ceiled, clipped to [0, dim - 1]."""
    def at(rotations):
        return (dim * math.log(yarn.original_max_position
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(at(yarn.beta_fast)), 0),
            min(math.ceil(at(yarn.beta_slow)), dim - 1))


def yarn_freqs(dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): the plain ones below the ramp's
    start, those divided by ``factor`` past its end, a linear blend
    between."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** exps
    inter = 1.0 / (yarn.factor * theta ** exps)
    low, high = yarn_range(dim, theta, yarn)
    span = (high - low) if high != low else 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / span).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """x [..., S, H, hd] (hd even), positions [..., S] -> rotated x: the
    two halves of hd rotate as pairs (not interleaved), in float32;
    ``mscale`` scales cos and sin (YaRN's ratio of attention factors)."""
    ang = positions[..., None].float() * inv_freq          # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- loss

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels==ignore_id are masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1,
                      labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)


def causal_mask(S: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))
