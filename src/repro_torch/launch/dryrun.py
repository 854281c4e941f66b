"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): every
(architecture x input shape) on the production meshes, the state a device
holds, and roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --lda --lda-k 2000

The reference lowers and compiles each cell for 512 placeholder devices
and reads XLA's cost analysis.  The port runs rank 0's program: one
process joins a fake process group (``torch.testing``'s ``FakeStore``,
world 512), builds the production ``DeviceMesh`` on it, places the params
(``init(device="meta")``) as meta DTensors by the validated rule table,
and runs one step on them.  DTensor splits each op into rank 0's local
ops and the collectives it needs; `CostCounter` counts on those: FLOPs by
``torch.utils.flop_counter``'s formulas (matmuls and attention; the
elementwise work is not counted), bytes as each aten op's operands and
results (eager and unfused, as the port runs), and each collective's
payload and group size, turned into link bytes by
``roofline.ring_bytes``.  Nothing is allocated: meta tensors hold no data,
and the fake group moves none.  Placing the params issues collectives of
its own; they fall outside the counted step.

Where DTensor has no sharding rule for an op (or one that fails), the
op's DTensor operands are replicated (the batch dim first kept split) and
the op runs again (`ReplicateFallback`); each such op is named in the
record's ``replicated_fallbacks``, and its all-gathers are counted.

The MoE cells run the expert-parallel island (``models/moe.py``), so
DTensor never sees the data-dependent dispatch.  ``--lda`` runs the
paper's own cell: rank 0's POBP body (``core/pobp.py::
shard_map_minibatch_fn``) on the CPU at PUBMED width, its collectives
counted by iteration.  Records go to ``--out`` (default
``results/dryrun_torch``); a record's keys with no torch counterpart (the
compiled program's) say so under their names.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, SHAPES, SMOKE_SHAPES,
                                 cell_supported, get_config, input_specs)
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.sharding import (P, _mesh_axes, _zip_map, batch_specs,
                                       cache_pspecs, param_specs, placements,
                                       validate_specs)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh, mesh_chip_count
from repro_torch.models import registry
from repro_torch.models.common import (ShardingCtx, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update

DEFAULT_OUT = "results/dryrun_torch"
FAKE_WORLD = 512

# the reference record's keys that read the compiled XLA program
NO_COUNTERPART = {
    "compile_s": "no torch counterpart: the port compiles no program "
                 "(see probe_s for the counting runs' seconds)",
    "hlo_flops": "no torch counterpart: XLA's cost analysis of the compiled "
                 "HLO (see counted_flops)",
    "hlo_bytes": "no torch counterpart: XLA's cost analysis of the compiled "
                 "HLO (see counted_bytes_unfused)",
    "scan_counted_once": "no torch counterpart: XLA counts a scanned "
                         "layer's body once; the port's probes are "
                         "unrolled Python loops",
    "hlo_flops_per_iter": "no torch counterpart: XLA's cost analysis (see "
                          "counted_flops_per_iter)",
    "hlo_bytes_per_iter": "no torch counterpart: XLA's cost analysis (see "
                          "counted_bytes_unfused_per_iter)",
}


# ------------------------------------------------------------ fake world

def fake_world(world_size: int = FAKE_WORLD) -> None:
    """Join a fake process group of ``world_size`` as rank 0 (no peers, no
    data moved), unless this process already has one.  It is process
    global: run the dry run in a process of its own."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()!r} group is up here")
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"the fake group has {dist.get_world_size()} "
                               f"ranks, the mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def dryrun_mesh(mesh_kind: str = "single", shape=None):
    """The production mesh (16 x 16 ``data, model``; ``multi``: 2 x 16 x
    16 ``pod, data, model``) on the fake group, or a mesh of ``shape``
    (2 dims: data, model; 3: pod, data, model)."""
    if shape is None:
        shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    shape = tuple(int(s) for s in shape)
    axes = ("pod", "data", "model")[-len(shape):]
    fake_world(max(FAKE_WORLD, int(np.prod(shape))))
    return make_mesh(shape, axes, device_type="cpu")


# ---------------------------------------------------------------- counts

_COLLECTIVE_TYPES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
_NOT_DATA = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(x):
    from torch.utils._pytree import tree_leaves as leaves

    return [t for t in leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(func, args) -> int:
    """The group size of a collective op's call: its ``group_size``
    argument, else the process group (object or registered name) it
    runs on."""
    import torch.distributed.distributed_c10d as c10d

    names = [a.name for a in func._schema.arguments]
    if "group_size" in names:
        return int(args[names.index("group_size")])
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except Exception:  # noqa: BLE001 — not a group name
                continue
        if isinstance(a, torch.ScriptObject):     # a c10d ProcessGroup
            return torch.distributed.ProcessGroup.unbox(a).size()
    raise ValueError(f"no group size in the call of {func}")


class CostCounter(TorchDispatchMode):
    """Counts what one rank runs: FLOPs by ``torch.utils.flop_counter``'s
    formulas, bytes as each aten op's tensor operands and results (views
    and allocations move none), and each collective as (type, payload
    bytes, group size): the result for a gather or scatter, the input
    for the others.  DTensor ops are handed to DTensor first, so the
    counts see its local ops and collectives."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.unknown_collectives = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers an op's output shape on
            # fake tensors of the global shape: no rank runs that
            return out
        if not isinstance(func, torch._ops.OpOverload):
            return out
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional", "_c10d_functional_autograd"):
            if name in _NOT_DATA:
                return out
            kind = _COLLECTIVE_TYPES.get(name)
            if kind is None:
                self.unknown_collectives[name] = \
                    self.unknown_collectives.get(name, 0) + 1
                return out
            # a functional gather or scatter returns its result; c10d's
            # in-place ops take the output (or, for an all-reduce, the
            # tensors reduced) first
            sized = out if ns != "c10d" and kind in (
                "all-gather", "reduce-scatter") else args[0]
            payload = _nbytes(_tensors(sized))
            self.collectives.append((kind, payload, _group_size(func, args)))
            return out
        pk = func._overloadpacket
        if pk in flop_registry:
            self.flops += flop_registry[pk](*args, **kwargs, out_val=out)
        if func.is_view or "empty" in name or name in (
                "detach", "alias", "lift_fresh", "_local_scalar_dense"):
            return out
        self.bytes += _nbytes(_tensors((args, kwargs))) + \
            _nbytes(_tensors(out))
        return out

    def costs(self) -> Dict[str, float]:
        cb = rl.ring_bytes(self.collectives)
        out = {"counted_flops": float(self.flops),
               "counted_bytes_unfused": float(self.bytes),
               "coll_total": cb["total"]}
        out.update({f"coll_{k}": v for k, v in cb.items() if k != "total"})
        return out


def _refused(e: BaseException) -> bool:
    """Whether ``e`` is DTensor refusing an op (no sharding strategy for
    it, none for these placements, or a redistribution it cannot plan),
    as distinct from an error of the op itself: DTensor infers the op's
    output on fake tensors of the global shape before it picks a
    strategy, so a shape or dtype fault of the model's code is raised
    outside DTensor's package, and a refusal inside it."""
    from torch.distributed import tensor as dtensor

    # DTensor raises an error of its propagation again as a RuntimeError
    # saying "Sharding propagation failed", from the original
    while e.__cause__ is not None and "Sharding propagation failed" in str(e):
        e = e.__cause__
    if isinstance(e, NotImplementedError) and "sharding strategy" in str(e):
        return True
    tb = e.__traceback__
    while tb is not None and tb.tb_next is not None:
        tb = tb.tb_next
    return tb is not None and tb.tb_frame.f_code.co_filename.startswith(
        os.path.dirname(dtensor.__file__) + os.sep)


class ReplicateFallback(TorchDispatchMode):
    """Runs a DTensor op again on replicated operands when DTensor's
    sharding propagation refuses it (`_refused`; any other error, such
    as a shape fault in the model code, propagates): first with only the batch dim (dim 0) still split, then with
    every operand replicated; ``ops`` counts each op that fell back, by
    name and by how far.  ``gather``'s input and ``embedding``'s table
    are replicated along the dim they index up front.  A dispatch mode,
    so the ops that activation checkpointing recomputes in the backward
    pass fall back too; enter it inside `CostCounter`, which then counts
    what the fallback's redistributions move."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map as pmap

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        # gathers along a split (or partial) dim: DTensor's masked partial
        # sum of such a dim neither survives an index that follows it nor
        # takes a partial cotangent, so that dim is gathered up front
        x, d = None, None
        if func is torch.ops.aten.gather.default:
            x, d = args[0], args[1] % args[0].ndim
        elif func is torch.ops.aten.embedding.default:
            x, d = args[0], 0
        if isinstance(x, DTensor):
            pl = [p if p.is_shard() and not p.is_shard(d) else Replicate()
                  for p in x.placements]
            if pl != list(x.placements):
                key = f"{func._schema.name} (dim {d} gathered first)"
                self.ops[key] = self.ops.get(key, 0) + 1
                args = (x.redistribute(x.device_mesh, pl),) + tuple(args[1:])
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — a refusal falls back below
            if not _refused(e):
                raise
        name = func._schema.name

        def rep(keep_batch):
            def one(t):
                if not isinstance(t, DTensor):
                    return t
                pl = [p if keep_batch and p.is_shard(0) else Replicate()
                      for p in t.placements]
                return t.redistribute(t.device_mesh, pl)
            return one

        try:
            out = func(*pmap(rep(True), args), **pmap(rep(True), kwargs))
            key = f"{name} (batch dim kept)"
        except Exception as e:  # noqa: BLE001 — then replicate everything
            if not _refused(e):
                raise
            out = func(*pmap(rep(False), args), **pmap(rep(False), kwargs))
            key = f"{name} (replicated)"
        self.ops[key] = self.ops.get(key, 0) + 1
        return out


# ---------------------------------------------------------------- counts

def n_params(params) -> int:
    return int(sum(x.numel() for _, x in tree_leaves(params)))


def n_active_params(cfg: ArchConfig, total: int) -> float:
    """Active params per token (MoE: only routed top-k experts count)."""
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    n_moe_layers = cfg.n_layers - cfg.dense_first_n
    inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
    return float(total - inactive)


def _dp_size(mesh) -> int:
    sizes = _mesh_axes(mesh)[1]
    n = 1
    for a in ("pod", "data"):
        if a in sizes:
            n *= sizes[a]
    return n


def grad_accum_steps(cfg: ArchConfig, shape: ShapeSpec, mesh,
                     budget_bytes: float = 1e9) -> int:
    """Microbatch count so the saved residual carries fit the budget.

    Per-device carry bytes ~= n_saved_layers * (B_loc/k) * S * d_model * 2,
    already divided by the TP degree via sequence parallelism."""
    dp = _dp_size(mesh)
    tp = _mesh_axes(mesh)[1].get("model", 1)
    if cfg.family in ("vlm",):
        n_saved = cfg.n_layers // cfg.cross_attn_every
    elif cfg.family == "hybrid":
        n_saved = cfg.n_layers // cfg.shared_attn_every
    elif cfg.family == "audio":
        n_saved = cfg.n_layers + (cfg.enc_layers or cfg.n_layers)
    else:
        n_saved = cfg.n_layers
    b_loc = max(1, shape.global_batch // dp)
    carry = n_saved * b_loc * shape.seq_len * cfg.d_model * 2 / tp
    k = 1
    while carry / k > budget_bytes and k < b_loc:
        k *= 2
    # floor: micro-batch <= 4 rows/device — bounds the B-proportional
    # transients (attention chunks, SSD chunk buffers) at >=2B-param widths
    if cfg.d_model >= 2048:
        k = max(k, min(b_loc, -(-b_loc // 4)))
    return k


def probe_plan(cfg: ArchConfig):
    """(make_cfg(c), (c_a, c_b, c_full)) — c counts stack entries.

    Costs are counted on two unrolled reduced-depth builds and
    extrapolated affinely in the stack length (exact: a step's cost is
    a + b*c)."""
    if cfg.family == "vlm":
        g, full = cfg.cross_attn_every, cfg.n_layers // cfg.cross_attn_every
        return (lambda c: dataclasses.replace(cfg, n_layers=c * g,
                                              scan_layers=False), (1, 2, full))
    if cfg.family == "hybrid":
        g, full = cfg.shared_attn_every, cfg.n_layers // cfg.shared_attn_every
        return (lambda c: dataclasses.replace(cfg, n_layers=c * g,
                                              scan_layers=False), (1, 2, full))
    if cfg.family == "audio":
        return (lambda c: dataclasses.replace(cfg, n_layers=c, enc_layers=c,
                                              scan_layers=False),
                (1, 2, cfg.n_layers))
    full = cfg.n_layers - cfg.dense_first_n
    return (lambda c: dataclasses.replace(
        cfg, n_layers=c + cfg.dense_first_n, scan_layers=False), (1, 2, full))


# ------------------------------------------------------------ the cells

def _place(tree, specs, mesh):
    """``tree``'s meta leaves as DTensors on ``mesh`` by ``specs`` (no
    data is scattered: each rank's block is made in place)."""
    from torch.distributed.tensor import distribute_tensor

    return _zip_map(lambda spec, t: distribute_tensor(
        t, mesh, placements(spec, mesh), src_data_rank=None), specs, tree)


def _local_bytes(tree, specs, mesh, itemsize: Optional[int] = None) -> int:
    """The bytes of one device's blocks of ``tree`` under validated
    ``specs`` (every split divides), at each leaf's itemsize or at
    ``itemsize``."""
    sizes = _mesh_axes(mesh)[1]
    total = [0]

    def one(spec, t):
        n = t.numel()
        for entry in spec:
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                n //= int(np.prod([sizes[a] for a in axes]))
        total[0] += n * (itemsize or t.element_size())
        return spec

    _zip_map(one, specs, tree)
    return total[0]


def _decode_specs(cfg, shape, mesh, dp):
    """(cache, its specs, the token, its spec) of a decode cell."""
    B, S = shape.global_batch, shape.seq_len
    cache_s = registry.cache_specs(cfg, B, S)
    c_specs = validate_specs(cache_pspecs(cache_s, mesh, cfg), cache_s, mesh)
    tok_s = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tok_spec = P(dp) if B % _dp_size(mesh) == 0 and B > 1 else P()
    return cache_s, c_specs, tok_s, validate_specs(tok_spec, tok_s, mesh)


def state_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Dict[str, int]:
    """What one device holds between steps, exactly from the validated
    specs: its blocks of the params, the AdamW state (float32 master, m
    and v; training), the batch, and the decode cache.  State bytes, not
    live bytes: a step's activations and transients are not in it."""
    dp = tuple(a for a in _mesh_axes(mesh)[0] if a in ("pod", "data"))
    params_s = registry.build(cfg).init(cfg, seed=0, device="meta")
    p_specs = validate_specs(param_specs(params_s), params_s, mesh)
    out = {"params": _local_bytes(params_s, p_specs, mesh)}
    if shape.kind == "train":
        # float32 master, m and v, and the int32 step count
        out["adamw"] = 3 * _local_bytes(params_s, p_specs, mesh,
                                        itemsize=4) + 4
    if shape.kind in ("train", "prefill"):
        batch_s = input_specs(cfg, shape)
        out["batch"] = _local_bytes(
            batch_s, validate_specs(batch_specs(batch_s, mesh), batch_s,
                                    mesh), mesh)
    else:
        cache_s, c_specs, tok_s, tok_spec = _decode_specs(cfg, shape, mesh,
                                                          dp)
        out["cache"] = _local_bytes(cache_s, c_specs, mesh)
        out["batch"] = _local_bytes(tok_s, tok_spec, mesh)
    out["total"] = sum(out.values())
    return out


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """``step()``: one step of the cell on rank 0's meta DTensors, with an
    active ``ShardingCtx`` (train: the loss forward and backward over
    ``grad_accum_steps`` micro-batches, then ``adamw_update``; prefill: a
    forward; decode: one ``decode_step``)."""
    mod = registry.build(cfg)
    dp = tuple(a for a in _mesh_axes(mesh)[0] if a in ("pod", "data"))
    params_s = mod.init(cfg, seed=0, device="meta")
    params = _place(params_s, validate_specs(param_specs(params_s), params_s,
                                             mesh), mesh)

    if shape.kind == "train":
        # sequence-parallel residual stream: the saved per-layer carries
        # shrink by the TP degree
        ctx = ShardingCtx(active=True, batch=dp, model="model", seq="model",
                          mesh=mesh)
        accum = grad_accum_steps(cfg, shape, mesh)
        opt = AdamWState(
            master=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params),
            m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
            v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
            step=torch.zeros((), dtype=torch.int32, device="meta"))
        batch_s = input_specs(cfg, shape)
        batch = _place(batch_s, validate_specs(batch_specs(batch_s, mesh),
                                               batch_s, mesh), mesh)
        acfg = AdamWConfig()

        def micro(i):
            # each rank's micro-batch i: rows of its own block, as a data-
            # parallel trainer takes them
            from torch.distributed.tensor import DTensor

            def one(x):
                loc = x.to_local()
                n = loc.shape[0] // accum
                return DTensor.from_local(loc[i * n:(i + 1) * n], mesh,
                                          x.placements, run_check=False)

            return {k: one(v) for k, v in batch.items()}

        def step():
            leaves = [x.detach().requires_grad_() for _, x in
                      tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            gsum, lsum = None, 0.0
            for i in range(accum):
                loss = mod.loss_fn(p, batch if accum == 1 else micro(i),
                                   cfg, ctx)
                g = torch.autograd.grad(loss, leaves)
                # accumulated in the grad dtype, as the reference does
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + loss.detach()
            grads = tree_unflatten(params, [x / accum for x in gsum])
            adamw_update(grads, opt, acfg)
            return lsum / accum

        return step

    ctx = ShardingCtx(active=True, batch=dp, model="model", mesh=mesh)
    if shape.kind == "prefill":
        batch_s = input_specs(cfg, shape)
        batch = _place(batch_s, validate_specs(batch_specs(batch_s, mesh),
                                               batch_s, mesh), mesh)

        @torch.no_grad()
        def step():
            if cfg.family == "audio":
                return mod.forward(params, batch["tokens"], batch["frames"],
                                   cfg, ctx, mode="prefill")[:2]
            return mod.forward(params, batch["tokens"], cfg, ctx,
                               image_embeds=batch.get("image_embeds"),
                               mode="prefill")[:2]

        return step

    # decode: one token against a cache of length seq_len
    cache_s, c_specs, tok_s, tok_spec = _decode_specs(cfg, shape, mesh, dp)
    cache = _place(cache_s, c_specs, mesh)
    token = _place(tok_s, tok_spec, mesh)

    @torch.no_grad()
    def step():
        # the write index: the last slot (the step attends over the whole
        # cache under a mask wherever it writes)
        return mod.decode_step(params, token, cache, shape.seq_len - 1, cfg,
                               ctx)

    return step


def _run_counted(cfg, shape, mesh):
    """Build a cell, run one step of it counted; returns (costs,
    fallbacks)."""
    from torch.distributed.tensor.experimental import implicit_replication

    step = build_cell(cfg, shape, mesh)
    fb = ReplicateFallback()
    counter = CostCounter()
    with counter, fb, implicit_replication():
        step()
    costs = counter.costs()
    if counter.unknown_collectives:
        costs["uncounted_collectives"] = dict(counter.unknown_collectives)
    return costs, fb.ops


def measure_costs(cfg, shape, mesh) -> Dict[str, Any]:
    """One counted step of the cell: counted_flops, counted_bytes_unfused,
    coll_total and coll_<type> (per device)."""
    return _run_counted(cfg, shape, mesh)[0]


def extrapolate_costs(cfg: ArchConfig, shape, mesh) -> Dict[str, Any]:
    """Two unrolled probes -> affine extrapolation of every cost metric."""
    mk, (ca, cb_, cfull) = probe_plan(cfg)
    proben, fallbacks = {}, {}
    for c in (ca, cb_):
        costs, fb = _run_counted(mk(c), shape, mesh)
        proben[c] = costs
        for k, v in fb.items():
            fallbacks[k] = max(fallbacks.get(k, 0), v)
    out: Dict[str, Any] = {}
    for k, v in proben[ca].items():
        if isinstance(v, float):
            slope = (proben[cb_][k] - v) / (cb_ - ca)
            out[k] = max(0.0, v + slope * (cfull - ca))
    out["probe_counts"] = (ca, cb_, cfull)
    out["probe_raw"] = proben
    out["replicated_fallbacks"] = fallbacks
    return out


def _roofline_update(rec, costs, cfg, shape, active, chips) -> None:
    terms = rl.roofline_terms(costs["counted_flops"],
                              costs["counted_bytes_unfused"],
                              costs["coll_total"])
    mf = rl.model_flops(cfg, shape, active, chips)
    rec.update(
        counted_flops=costs["counted_flops"],
        counted_bytes_unfused=costs["counted_bytes_unfused"],
        counted_collective_bytes={k[5:]: v for k, v in costs.items()
                                  if k.startswith("coll_")},
        probe_counts=costs["probe_counts"], probe_raw=costs["probe_raw"],
        replicated_fallbacks=costs["replicated_fallbacks"],
        compute_s=terms.compute_s, memory_s=terms.memory_s,
        collective_s=terms.collective_s, dominant=terms.dominant,
        model_flops=mf,
        useful_flop_ratio=mf / max(costs["counted_flops"], 1.0),
        roofline_fraction=terms.fraction_of_roofline,
    )


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             probes: bool = True, *, mesh=None,
             smoke: bool = False) -> Dict[str, Any]:
    """One cell: params, the state a device holds, and (with ``probes``)
    roofline terms from two counted unrolled probes.  Without ``probes``
    one probe runs, which shows the cell runs on the mesh, and the record
    keeps its counts and the analytic ``model_flops``.  ``smoke``
    takes ``reduced()`` configs and the smoke shapes; ``mesh`` replaces
    the production mesh."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind}
    if not cell_supported(arch, shape_name):
        rec["status"] = "skipped (full attention; long_500k is for "
        rec["status"] += "sub-quadratic families — DESIGN.md §6)"
        return rec
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    mesh = mesh if mesh is not None else dryrun_mesh(mesh_kind)
    chips = mesh_chip_count(mesh)

    total = n_params(registry.build(cfg).init(cfg, seed=0, device="meta"))
    active = n_active_params(cfg, total)
    rec.update(status="ok", chips=chips, params_total=total,
               params_active=int(active), memory=rl.memory_info(),
               state_bytes_per_device=state_bytes(cfg, shape, mesh),
               **{k: NO_COUNTERPART[k] for k in (
                   "compile_s", "scan_counted_once", "hlo_flops",
                   "hlo_bytes")})
    t0 = time.time()
    if probes:
        costs = extrapolate_costs(cfg, shape, mesh)
        rec["probe_s"] = round(time.time() - t0, 1)
        _roofline_update(rec, costs, cfg, shape, active, chips)
    else:
        mk, (ca, _, _) = probe_plan(cfg)
        raw, fb = _run_counted(mk(ca), shape, mesh)
        rec.update(probe_s=round(time.time() - t0, 1), probe_counts=(ca,),
                   probe_raw={ca: raw}, replicated_fallbacks=fb,
                   model_flops=rl.model_flops(cfg, shape, active, chips))
    return rec


# ------------------------------------------------------------- LDA cells

def run_lda_cell(K: int, mesh_kind: str, sync_mode: str,
                 D_m: int = 8192, L: int = 128, W: int = 141043, *,
                 mesh=None, seed: int = 0) -> Dict[str, Any]:
    """The paper's own workload at PUBMED scale on the production mesh:
    one POBP mini-batch, documents over the data (and pod) axes, topics
    over the model axis.  Rank 0's body (``shard_map_minibatch_fn``, the
    driver's ``--backend shard_map`` step) runs on the CPU on data from
    ``seed``, once with 1 iteration and once with 3 (tolerance off), and
    the counted collectives of the two runs split into the first
    iteration's (``once_coll_bytes``) and each further one's
    (``loop_coll_bytes_per_iter``), as the reference splits them by the
    compiled while body."""
    from repro_torch.core.pobp import shard_map_minibatch_fn
    from repro_torch.core.sync import dense_sync_bytes, power_sync_bytes
    from repro_torch.core.types import LDAConfig

    mesh = mesh if mesh is not None else dryrun_mesh(mesh_kind)
    chips = mesh_chip_count(mesh)
    model_size = _mesh_axes(mesh)[1]["model"]
    cfg = LDAConfig(vocab_size=W, num_topics=K,
                    lambda_w=0.1,
                    lambda_k_abs=max(1, round(50 / model_size)),  # global ~50
                    inner_iters=200, residual_tol=0.1)
    rng = np.random.default_rng(seed)
    word_ids = torch.from_numpy(rng.integers(0, W, (D_m, L), dtype=np.int32))
    counts = torch.from_numpy(
        rng.integers(1, 4, (D_m, L)).astype(np.float32))
    phi = torch.from_numpy(rng.random((W, K // model_size),
                                      dtype=np.float32))

    t0 = time.time()
    runs = {}
    for iters in (1, 3):
        fn, meter = shard_map_minibatch_fn(
            dataclasses.replace(cfg, inner_iters=iters, residual_tol=-1.0),
            mesh, sync_mode)
        counter = CostCounter()
        with counter:
            _, ran, _ = fn(word_ids, counts, phi.clone(), 1.0,
                           generator=torch.Generator().manual_seed(seed))
        if int(ran) != iters:
            raise RuntimeError(f"the {iters}-iteration probe ran {ran}")
        runs[iters] = (counter.costs(), meter.bytes_by_phase)
    probe_s = time.time() - t0
    c1, c3 = runs[1][0], runs[3][0]
    per_iter = {k: (c3[k] - c1[k]) / 2 for k in c1}
    once_bytes, loop_bytes = c1["coll_total"], per_iter["coll_total"]
    # packed phi+r and the r_w vector (Eq. 6) / per-device phi+r (Eq. 5)
    analytic_power = power_sync_bytes(cfg.num_power_words,
                                      cfg.num_power_topics, W)
    analytic_dense = 2 * dense_sync_bytes(W, K // model_size)
    T = cfg.inner_iters
    total_coll = once_bytes + loop_bytes * (T - 1)
    flops, nbytes = per_iter["counted_flops"], \
        per_iter["counted_bytes_unfused"]
    return {
        "arch": f"lda-pubmed-K{K}", "shape": f"pobp_{sync_mode}",
        "mesh": mesh_kind, "status": "ok", "chips": chips,
        "compile_s": NO_COUNTERPART["compile_s"], "memory": rl.memory_info(),
        "hlo_flops_per_iter": NO_COUNTERPART["hlo_flops_per_iter"],
        "hlo_bytes_per_iter": NO_COUNTERPART["hlo_bytes_per_iter"],
        "counted_flops_per_iter": flops,
        "counted_bytes_unfused_per_iter": nbytes,
        "loop_coll_bytes_per_iter": loop_bytes,
        "once_coll_bytes": once_bytes,
        "loop_coll_bytes_by_type": {k[5:]: v for k, v in per_iter.items()
                                    if k.startswith("coll_")},
        "analytic_loop_bytes_per_iter": (
            analytic_power if sync_mode == "power" else analytic_dense),
        "minibatch_coll_bytes_T200": total_coll,
        "meter_bytes_by_phase_3_iters": runs[3][1],
        "probe_iters": (1, 3), "probe_s": round(probe_s, 1),
        "compute_s": flops / rl.HW["peak_flops"],
        "memory_s": nbytes / rl.HW["hbm_bw"],
        "collective_s": total_coll / rl.HW["link_bw"],
        "dominant": max(
            (("compute", flops / rl.HW["peak_flops"]),
             ("memory", nbytes / rl.HW["hbm_bw"]),
             ("collective", loop_bytes / rl.HW["link_bw"])),
            key=lambda kv: kv[1])[0],
        "cfg": {"W": W, "K": K, "D_m": D_m, "L": L,
                "P": cfg.num_power_words, "Pk": cfg.num_power_topics},
    }


# ------------------------------------------------------------------ main

def _write(fp: str, rec: Dict[str, Any]) -> None:
    with open(fp, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _reprobe(args, mesh_shape) -> None:
    import glob

    for fp in sorted(glob.glob(os.path.join(args.out, "*__single.json"))):
        with open(fp) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or "lda-pubmed" in rec["arch"]:
            continue
        print(f"[reprobe] {os.path.basename(fp)} ...", flush=True)
        try:
            cfg = get_config(rec["arch"])
            if args.smoke:
                cfg = cfg.reduced()
            shape = (SMOKE_SHAPES if args.smoke else SHAPES)[rec["shape"]]
            mesh = dryrun_mesh("single", mesh_shape)
            costs = extrapolate_costs(cfg, shape, mesh)
            _roofline_update(rec, costs, cfg, shape, rec["params_active"],
                             rec["chips"])
            _write(fp, rec)
            print(f"[done] {rec['arch']}/{rec['shape']}: "
                  f"dominant={rec['dominant']} "
                  f"coll={rec['collective_s']:.2e}s", flush=True)
        except Exception as e:  # noqa: BLE001 — a cell's failure is its record
            print(f"[reprobe FAILED] {fp}: {e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lda", action="store_true",
                    help="run the paper's own POBP cells (PUBMED scale)")
    ap.add_argument("--reprobe", action="store_true",
                    help="recompute roofline probes for existing records "
                         "(e.g. after a counting fix)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--lda-k", type=int, nargs="+", default=[2000, 10000],
                    help="the --lda cells' topic counts")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced() configs at the smoke shapes")
    ap.add_argument("--mesh-shape", default=None,
                    help="a mesh other than the production one, e.g. 2,2 "
                         "(data, model) or 2,2,2 (pod, data, model); "
                         "--mesh still names the records")
    args = ap.parse_args(argv)
    mesh_shape = (None if args.mesh_shape is None else
                  tuple(int(s) for s in args.mesh_shape.split(",")))

    def mesh_for(kind):
        return dryrun_mesh(kind, mesh_shape)

    if args.reprobe:
        _reprobe(args, mesh_shape)
        return

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    if args.lda:
        for K in args.lda_k:
            for mode in ("power", "dense"):
                for mk in meshes:
                    tag = f"lda-pubmed-K{K}__pobp_{mode}__{mk}"
                    fp = os.path.join(args.out, tag + ".json")
                    if os.path.exists(fp):
                        print(f"[skip existing] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        rec = run_lda_cell(K, mk, mode, mesh=mesh_for(mk))
                    except Exception as e:  # noqa: BLE001
                        rec = {"arch": f"lda-pubmed-K{K}",
                               "shape": f"pobp_{mode}", "mesh": mk,
                               "status": f"FAILED: {type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()}
                    _write(fp, rec)
                    print(f"[done] {tag}: {rec.get('status')}", flush=True)
        return

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    for arch, shape in cells:
        for mk in meshes:
            tag = f"{arch}__{shape}__{mk}"
            fp = os.path.join(args.out, tag + ".json")
            if os.path.exists(fp):
                print(f"[skip existing] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                # roofline probes are single-pod only; the multi-pod pass
                # shows the 'pod' axis shards
                rec = run_cell(arch, shape, mk, probes=(mk == "single"),
                               mesh=mesh_for(mk), smoke=args.smoke)
            except Exception as e:  # noqa: BLE001 — a failure is the record
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": f"FAILED: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
            _write(fp, rec)
            status = rec.get("status")
            extra = ""
            if status == "ok" and "dominant" in rec:
                extra = (f" dominant={rec['dominant']}"
                         f" compute={rec['compute_s']:.2e}s"
                         f" mem={rec['memory_s']:.2e}s"
                         f" coll={rec['collective_s']:.2e}s"
                         f" probe={rec['probe_s']:.0f}s")
            elif status == "ok":
                extra = f" probe={rec['probe_s']:.0f}s (memory-fit pass)"
            print(f"[done] {tag}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
