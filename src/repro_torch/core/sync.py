"""Synchronization layer of the port (counterpart of ``repro.core.sync``):
the dense (Eq. 4) and power-selected (Eq. 6) all-reduces, and the byte
meter that bills them.

One shard body serves every execution mode, through the reducer it is
handed:

  - ``LocalReducer``: one shard, nothing crosses (OBP, N = 1);
  - ``SimReducer``: N shards in lockstep on one device, each on a thread
    of its own (`lockstep`); a psum meets the other shards of its group
    and sums their payloads in shard order, the reference's
    ``vmap(axis_name="shards")``;
  - ``StackedReducer``: shards stacked on a leading axis of every tensor,
    the psum a sum over that axis (topic-sharded serving, the reference's
    ``SimReducer``);
  - ``MeshReducer``: ``torch.distributed.all_reduce`` over one group of a
    ``DeviceMesh`` axis, one process a mesh position, the reference's
    ``lax.psum`` over a named mesh axis;
  - ``RankStackedReducer``: a rank's topic shards stacked as in
    ``StackedReducer``, summed across the ranks by a ``MeshReducer``
    (topic-sharded serving over a mesh);
  - ``PSReducer``: the parameter server's wire model around one of the
    others, which still does the sum (``--backend ps``).

The byte meter bills each psum's logical payload (size x itemsize) under
a phase label.  The reference records at trace time, once per traced
program section; the port runs eagerly, so its shard bodies mark their
sections (`CommMeter.section`): the once-a-batch part of a mini-batch is
one log, each inner iteration another, and the logs merge as the
reference's traces do (identical logs count once, shape-bucket variants
take the per-phase max, distinct sections add).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# phases paid once per inner iteration; every other phase once per batch.
# `PSReducer` splits each vocabulary-row payload into a ``.push`` and a
# ``.pull`` leg: both count as loop phases.
_BASE_LOOP_PHASES = ("power", "dense_loop", "model_rw_loop", "model_norm_loop")
LOOP_PHASES = _BASE_LOOP_PHASES + tuple(
    f"{p}{leg}" for p in _BASE_LOOP_PHASES for leg in (".push", ".pull"))

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def wire_dtype(dtype) -> torch.dtype:
    """A sync dtype given as a torch dtype or by name ('float32',
    'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown sync dtype {dtype!r}") from None


class CommMeter:
    """Logical-byte counter of a program's collectives, by phase.

    Records made inside a `section` form that section's ordered log of
    (phase, shape, dtype, bytes, w_rows).  The logs merge as the
    reference's trace logs do:

      - identical logs count once (every inner iteration, every shard and
        every mini-batch of one shape records the same log);
      - logs with the same phase sequence but other payload shapes are
        shape-bucket variants of one section (the L-dependent
        ``model_norm`` across length buckets): the per-phase max is taken;
      - distinct phase sequences add.

    Records made outside any section accumulate per call, as the
    reference's eager (untraced) records do; so do `record_host`'s.
    Sections are per thread, so the shards of a `lockstep` run record
    side by side.  Distinct logs are kept once each, so the meter's size
    does not grow with the length of a stream.
    """

    def __init__(self) -> None:
        self._logs: Dict[Tuple, None] = {}       # distinct closed logs
        self._eager: List[Tuple] = []
        self._open = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    @contextlib.contextmanager
    def section(self):
        """Records inside form one log (a traced program section of the
        reference); a section nested in another logs apart from it."""
        stack = self._stack()
        stack.append([])
        try:
            yield
        finally:
            log = tuple(stack.pop())
            if log:
                with self._lock:
                    self._logs[log] = None

    def record(self, phase: str, x: torch.Tensor,
               w_rows: Optional[int] = None) -> None:
        """Register one psum payload.  ``w_rows`` marks a payload whose
        size is proportional to the vocabulary: billed at the full
        ``w_rows`` by `bytes_by_phase`, scaled to the live rows by
        `bytes_by_phase_at`."""
        nbytes = x.numel() * x.element_size()
        sig = (phase, tuple(x.shape), str(x.dtype), nbytes,
               int(w_rows) if w_rows else 0)
        stack = self._stack()
        if stack:
            stack[-1].append(sig)
        else:
            with self._lock:
                self._eager.append(sig)

    def record_host(self, phase: str, nbytes: int, w_rows: int = 0) -> None:
        """Register host-side wire traffic that no psum carries (the
        parameter server's retries and replays); accumulates per call."""
        with self._lock:
            self._eager.append((phase, (), "host", int(nbytes), int(w_rows)))

    def _merged(self, live_w: Optional[int] = None) -> Dict[str, int]:
        def scaled(nbytes: int, w_rows: int) -> int:
            if live_w is None or not w_rows:
                return nbytes
            return int(nbytes * min(int(live_w), w_rows) // w_rows)

        with self._lock:
            logs, eager = list(self._logs), list(self._eager)
        groups: Dict[Tuple[str, ...], Dict[str, int]] = {}
        for log in logs:
            per: Dict[str, int] = {}
            for phase, _, _, nbytes, w_rows in log:
                per[phase] = per.get(phase, 0) + scaled(nbytes, w_rows)
            g = groups.setdefault(tuple(s[0] for s in log), {})
            for phase, nbytes in per.items():
                g[phase] = max(g.get(phase, 0), nbytes)
        out: Dict[str, int] = {}
        for phase, _, _, nbytes, w_rows in eager:
            out[phase] = out.get(phase, 0) + scaled(nbytes, w_rows)
        for g in groups.values():
            for phase, nbytes in g.items():
                out[phase] = out.get(phase, 0) + nbytes
        return out

    @property
    def bytes_by_phase(self) -> Dict[str, int]:
        return self._merged()

    def bytes_by_phase_at(self, live_w: int) -> Dict[str, int]:
        """Per-phase bytes with the ``w_rows``-marked payloads scaled to a
        live vocabulary of ``live_w`` rows."""
        return self._merged(live_w)

    def phase_bytes(self, phase: str) -> int:
        return self.bytes_by_phase.get(phase, 0)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_phase.values())

    def per_minibatch_bytes(self, iters,
                            loop_phases: Sequence[str] = LOOP_PHASES,
                            live_w: Optional[int] = None) -> int:
        """``once + (iters - 1) * loop`` bytes of one mini-batch: the
        ``loop_phases`` payloads cross once per inner iteration, every
        other phase once per mini-batch; ``iters`` counts the dense
        iteration.  ``live_w`` scales as `bytes_by_phase_at` does."""
        by = self._merged(live_w)
        once = sum(v for p, v in by.items() if p not in loop_phases)
        loop = sum(v for p, v in by.items() if p in loop_phases)
        return int(once + max(int(iters) - 1, 0) * loop)

    def reset(self) -> None:
        with self._lock:
            self._logs.clear()
            self._eager.clear()


_CAST_CHUNK = 1 << 24      # elements a wire-cast pass takes at once


def _round_trip(x: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``wire`` and back, in passes: no full-size wire copy
    beside ``x`` and the result."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    for src, dst in zip(x.reshape(-1).split(_CAST_CHUNK),
                        out.view(-1).split(_CAST_CHUNK)):
        dst.copy_(src.to(wire))
    return out


class Reducer:
    """All-reduce provider; subclasses define where the sum happens
    (`_sum`) and how many shards it spans (`shards`)."""

    shards = 1

    def __init__(self, meter: Optional[CommMeter] = None,
                 sync_dtype=torch.float32):
        self.meter = meter or CommMeter()
        self.sync_dtype = wire_dtype(sync_dtype)

    def _wire(self, dtype) -> torch.dtype:
        return wire_dtype(dtype) if dtype is not None else self.sync_dtype

    def _payload(self, x: torch.Tensor) -> torch.Tensor:
        """What one shard sends of ``x`` (the meter bills it)."""
        return x

    def _sum(self, x: torch.Tensor, phase: str) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor, phase: str, compress: bool = True,
             w_rows: Optional[int] = None, dtype=None) -> torch.Tensor:
        """All-reduce ``x``; under ``compress`` the payload travels at the
        sync dtype (``dtype`` overrides it for this call).  Cast, record,
        sum, cast back: the reference's order.  The result is a tensor of
        this shard's own, never the caller's ``x``."""
        orig = x.dtype
        wire = self._wire(dtype)
        if compress and x.dtype != wire:
            x = x.to(wire)
        self.meter.record(phase, self._payload(x), w_rows=w_rows)
        return self._sum(x, phase).to(orig)

    def bill(self, x: torch.Tensor, phase: str,
             w_rows: Optional[int] = None) -> torch.Tensor:
        """Record a local full-statistic touch without reducing (the
        Robbins-Monro decay rescales the [W, K] statistic in place, memory
        traffic billed once per mini-batch).  Returns ``x``."""
        self.meter.record(phase, self._payload(x), w_rows=w_rows)
        return x


class LocalReducer(Reducer):
    """N = 1: no communication, so ``psum`` records nothing.  Under
    ``compress`` the payload still takes the sync dtype's cast round trip,
    so an N = 1 run computes what an N-shard run with that sync dtype
    computes."""

    def psum(self, x, phase: str, compress: bool = True,
             w_rows: Optional[int] = None, dtype=None):
        wire = self._wire(dtype)
        if not compress or x.dtype == wire:
            return x
        return _round_trip(x, wire)

    def _sum(self, x, phase):
        return x


class LockstepBroken(RuntimeError):
    """Raised in a shard whose psum cannot complete: another shard raised
    or finished without meeting it."""


class _Group:
    """The meeting point of one reduction group of a `SimReducer`: each
    member hands in its payload; the last to arrive sums them in member
    order and every member leaves with a tensor of its own."""

    def __init__(self, members: Sequence[int]):
        self.members = tuple(members)
        self.cv = threading.Condition()
        self.reset()

    def reset(self) -> None:
        self.slots: List[Optional[Tuple[str, torch.Tensor]]] = \
            [None] * len(self.members)
        self.arrived = 0
        self.generation = 0
        self.out: List[torch.Tensor] = []
        self.broken: Optional[str] = None

    def _reduce(self) -> List[torch.Tensor]:
        (phase, x0), *rest = self.slots
        for phase_i, x in rest:
            if (phase_i, x.shape, x.dtype) != (phase, x0.shape, x0.dtype):
                raise RuntimeError(
                    f"shards out of lockstep: psum {phase!r} {tuple(x0.shape)} "
                    f"{x0.dtype} met {phase_i!r} {tuple(x.shape)} {x.dtype}")
        total = x0.clone()
        for _, x in rest:
            total.add_(x)
        return [total] + [total.clone() for _ in rest]

    def exchange(self, k: int, phase: str, x: torch.Tensor) -> torch.Tensor:
        with self.cv:
            if self.broken:
                raise LockstepBroken(self.broken)
            self.slots[k] = (phase, x)
            self.arrived += 1
            gen = self.generation
            if self.arrived == len(self.members):
                try:
                    self.out = self._reduce()
                except BaseException as e:
                    self.break_(f"psum {phase!r} failed: {e!r}")
                    raise
                self.slots = [None] * len(self.members)
                self.arrived = 0
                self.generation += 1
                self.cv.notify_all()
            else:
                self.cv.wait_for(lambda: self.generation != gen
                                 or self.broken is not None)
                if self.generation == gen:
                    raise LockstepBroken(self.broken)
            return self.out[k]

    def depart(self, shard: int) -> None:
        """A member's body ended: shards still waiting in a psum (or
        arriving at one later) are out of lockstep."""
        with self.cv:
            if self.broken is None:
                waiting = self.arrived > 0
                self.broken = (f"shard {shard} finished while shards "
                               f"{'wait' if waiting else 'were to meet'} "
                               f"in a psum: shards out of lockstep")
                if waiting:
                    self.cv.notify_all()

    def break_(self, why: str) -> None:
        with self.cv:
            if self.broken is None:
                self.broken = why
            self.cv.notify_all()


class SimReducer(Reducer):
    """N shards in lockstep on one device, each on a thread of `lockstep`:
    the counterpart of the reference's psum over the ``vmap`` axis
    ``"shards"``.

    ``groups`` partitions the shards into reduction groups (default: one
    group of all); a psum sums the payloads of the caller's group in the
    group's order, so a run repeats bit for bit and every member receives
    identical bits, each in a tensor of its own (a shard may update its
    result in place).  Two reducers over one `lockstep` run, one grouping
    the shards by data and one by topic shard, simulate a data x model
    mesh.  The meter records each shard's payload; identical logs count
    once, so it bills what one shard sends.
    """

    def __init__(self, num_shards: int, meter: Optional[CommMeter] = None,
                 sync_dtype=torch.float32,
                 groups: Optional[Sequence[Sequence[int]]] = None):
        super().__init__(meter, sync_dtype)
        self.num_shards = int(num_shards)
        groups = ([list(range(self.num_shards))] if groups is None
                  else [list(g) for g in groups])
        if sorted(s for g in groups for s in g) != list(
                range(self.num_shards)) or len({len(g) for g in groups}) != 1:
            raise ValueError(f"groups {groups} must split shards "
                             f"0..{self.num_shards - 1} into equal groups")
        self._groups = [_Group(g) for g in groups]
        self._slot = {s: (grp, k) for grp in self._groups
                      for k, s in enumerate(grp.members)}
        self.shards = len(groups[0])
        self._local = threading.local()

    def _sum(self, x, phase):
        shard = getattr(self._local, "shard", None)
        if shard is None:
            raise RuntimeError("SimReducer.psum outside a lockstep run: "
                               "run the shard bodies with sync.lockstep")
        grp, k = self._slot[shard]
        return grp.exchange(k, phase, x)


def lockstep(body, num_shards: int, reducers: Sequence[SimReducer],
             device=None) -> list:
    """Run ``body(shard)`` for shard 0..N-1, each on a thread of its own,
    in lockstep through ``reducers`` (the `SimReducer`s the bodies
    psum through).  Returns the bodies' results in shard order.

    On a CUDA ``device`` each thread runs on that device and on the
    caller's current stream, so the shards' work queues in one stream
    and each psum's sum follows its payloads.  A shard that raises
    releases the others (their pending psums raise) and its exception is
    raised here; so is a shard left waiting in a psum the others never
    reach.  Draw anything random before the call, in shard order.
    """
    dev = torch.device(device) if device is not None else None
    stream = (torch.cuda.current_stream(dev)
              if dev is not None and dev.type == "cuda" else None)
    for red in reducers:
        if red.num_shards != num_shards:
            raise ValueError(f"reducer spans {red.num_shards} shards, the "
                             f"run {num_shards}")
        for grp in red._groups:
            grp.reset()
    results: list = [None] * num_shards
    errors: List[Optional[BaseException]] = [None] * num_shards

    def run(shard: int) -> None:
        for red in reducers:
            red._local.shard = shard
        try:
            if stream is not None:
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    results[shard] = body(shard)
            else:
                results[shard] = body(shard)
        except BaseException as e:  # noqa: BLE001 (raised in the caller)
            errors[shard] = e
            for red in reducers:
                for grp in red._groups:
                    grp.break_(f"shard {shard} raised {e!r}")
        else:
            for red in reducers:
                grp, _ = red._slot[shard]
                grp.depart(shard)
        finally:
            for red in reducers:
                red._local.shard = None

    threads = [threading.Thread(target=run, args=(s,), name=f"shard-{s}",
                                daemon=True) for s in range(num_shards)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    raised = [e for e in errors if e is not None]
    if raised:
        # the shard that failed, not the ones it released
        raise next((e for e in raised if not isinstance(e, LockstepBroken)),
                   raised[0])
    return results


class StackedReducer(Reducer):
    """Shards stacked on a leading axis of every tensor: the psum sums over
    it and every shard reads the sum (the reference's ``SimReducer``,
    the layout of topic-sharded serving).  The meter bills one shard's
    payload, ``x[0]``."""

    def __init__(self, num_shards: int, meter: Optional[CommMeter] = None,
                 sync_dtype=torch.float32):
        super().__init__(meter, sync_dtype)
        self.num_shards = self.shards = int(num_shards)

    def _payload(self, x):
        return x[0]

    def _sum(self, x, phase):
        return x.sum(dim=0, keepdim=True).expand_as(x)


class MeshReducer(Reducer):
    """``torch.distributed.all_reduce`` over one process group: one axis
    (or several, flattened) of a `DeviceMesh`, one process a mesh
    position.  NCCL's and gloo's all-reduce hand every rank identical
    bits, so decisions taken from psum'd values agree across ranks."""

    def __init__(self, group, meter: Optional[CommMeter] = None,
                 sync_dtype=torch.float32):
        import torch.distributed as dist

        super().__init__(meter, sync_dtype)
        self.group = group
        self.shards = dist.get_world_size(group)

    def _sum(self, x, phase):
        import torch.distributed as dist

        out = x.clone()
        if self.shards > 1:
            dist.all_reduce(out, group=self.group)
        return out


class RankStackedReducer(StackedReducer):
    """A rank's topic shards stacked on a leading axis, the other ranks'
    across a process group (topic-sharded serving over a mesh's ``model``
    axis): the psum sums this rank's stack, all-reduces that sum over the
    group through a `MeshReducer`, and every local shard reads the total.
    ``num_shards`` counts the shards of every rank; the meter bills one
    shard's payload, ``x[0]``, as a one-process `StackedReducer` over
    them does."""

    def __init__(self, num_local: int, group,
                 meter: Optional[CommMeter] = None,
                 sync_dtype=torch.float32):
        self.mesh = MeshReducer(group, meter, sync_dtype)
        super().__init__(int(num_local) * self.mesh.shards, self.mesh.meter,
                         sync_dtype)
        self.num_local = int(num_local)

    def _sum(self, x, phase):
        return self.mesh._sum(x.sum(dim=0, keepdim=True),
                              phase).expand_as(x)


class PSReducer(Reducer):
    """The parameter server's billing peer of the other reducers
    (DESIGN.md §15, ``dist/paramserver.py``).

    The step's math is unchanged: ``inner`` (a `LocalReducer` for one
    worker shard, a `SimReducer` for N in lockstep) still does every sum,
    so at staleness 0 the run follows the all-reduce backend.  The wire
    model changes:

      - a vocabulary-row payload (``w_rows``) crosses twice, as a touched-
        row push to the owning server shards and as a touched-row pull for
        the next mini-batch: it is billed as ``{phase}.push`` and
        ``{phase}.pull``, both ``w_rows``-marked, so
        ``bytes_by_phase_at(touched)`` bills the rows that travel;
      - a payload that is not rows never reaches the servers: with one
        worker shard (a `LocalReducer` inner) it is not billed, with
        several it still needs their all-reduce and is billed as is.

    Only this reducer records; the inner one sums.  ``bill`` is the base
    class's (a local statistic touch is the same under the server).
    """

    def __init__(self, inner: Reducer, *, meter: Optional[CommMeter] = None,
                 sync_dtype=None):
        super().__init__(meter or inner.meter,
                         inner.sync_dtype if sync_dtype is None
                         else sync_dtype)
        self.inner = inner
        self.shards = inner.shards

    def _payload(self, x):
        return self.inner._payload(x)

    def psum(self, x: torch.Tensor, phase: str, compress: bool = True,
             w_rows: Optional[int] = None, dtype=None) -> torch.Tensor:
        wire = self._wire(dtype)
        cast = compress and x.dtype != wire
        local = isinstance(self.inner, LocalReducer)
        if local:
            # nothing crosses: the wire's cast round trip in passes, as
            # `LocalReducer` takes it, and the bill from the payload's shape
            sent = torch.empty(x.shape, dtype=wire if cast else x.dtype,
                               device="meta")
        else:
            sent = x.to(wire) if cast else x
        if w_rows:
            self.meter.record(f"{phase}.push", self._payload(sent),
                              w_rows=w_rows)
            self.meter.record(f"{phase}.pull", self._payload(sent),
                              w_rows=w_rows)
        elif not local:
            self.meter.record(phase, self._payload(sent))
        if local:
            return _round_trip(x, wire) if cast else x
        return self.inner._sum(sent, phase).to(x.dtype)

    def _sum(self, x, phase):
        return self.inner._sum(x, phase)


def dense_sync_bytes(W: int, K: int, itemsize: int = 4) -> int:
    """Eq. (5) per-iteration payload of the dense baseline: the full phi
    matrix at the live vocabulary ``W``."""
    return W * K * itemsize


def power_sync_bytes(P: int, Pk: int, W: int, itemsize: int = 4,
                     rw_itemsize: int = 4) -> int:
    """Eq. (6) per-iteration payload of POBP: packed phi and packed r at
    ``itemsize`` plus the [W] word-residual vector at ``rw_itemsize``
    (float32: the residual syncs are never compressed)."""
    return 2 * P * Pk * itemsize + W * rw_itemsize


def touched_power_sync_bytes(P: int, Pk: int, touched_w: int,
                             itemsize: int = 4,
                             rw_itemsize: int = 4) -> int:
    """Eq. (6) when a worker exchanges only the rows its mini-batch
    touched: at most ``min(P, touched_w)`` packed rows, and the touched
    rows of the residual vector."""
    Pt = min(P, touched_w)
    return 2 * Pt * Pk * itemsize + touched_w * rw_itemsize


def mesh_axis_group(mesh, axes):
    """The process group of this rank over ``axes`` of ``mesh`` (a
    ``DeviceMesh``): the mesh's own group for one axis; for several (the
    ``("pod", "data")`` document shards), a group over those axes
    flattened in the order given, one for each position on the other
    axes, made collectively (every rank calls this, in the same order)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    ranks = mesh.mesh.permute(
        dims + [d for d in range(mesh.mesh.dim()) if d not in dims])
    columns = ranks.reshape(-1, int(torch.tensor(
        [mesh.mesh.shape[d] for d in range(mesh.mesh.dim())
         if d not in dims]).prod())).T
    mine = None
    for members in columns.tolist():
        group = dist.new_group(members)
        if dist.get_rank() in members:
            mine = group
    return mine
