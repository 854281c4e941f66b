"""Synchronization layer of the port: the byte meter and the single-shard
reducer (counterpart of ``repro.core.sync``).

Only the N = 1 reducer is ported.  The mesh, simulation and
parameter-server reducers, and topic sharding with them, come with the
multi-shard slice (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

# phases paid once per inner iteration; every other phase once per batch
LOOP_PHASES = ("power", "dense_loop", "model_rw_loop", "model_norm_loop")

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
    """Logical-byte counter of one program's collectives, by phase.

    The reference records at trace time, once per compiled program; the
    port runs eagerly, so a record whose (phase, shape, dtype) was seen
    before counts once, which gives the same per-program totals.  The
    single-shard reducer records only what it bills (the decay pass);
    live-W billing (``bytes_by_phase_at``) comes with the multi-shard
    slice.
    """

    def __init__(self) -> None:
        self._sigs: Dict[Tuple, int] = {}

    def record(self, phase: str, x: torch.Tensor) -> None:
        sig = (phase, tuple(x.shape), str(x.dtype))
        self._sigs[sig] = x.numel() * x.element_size()

    @property
    def bytes_by_phase(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (phase, _, _), nbytes in self._sigs.items():
            out[phase] = out.get(phase, 0) + nbytes
        return out

    @property
    def total_bytes(self) -> int:
        return sum(self._sigs.values())

    def per_minibatch_bytes(self, iters,
                            loop_phases: Sequence[str] = LOOP_PHASES) -> int:
        """``once + (iters - 1) * loop`` bytes of one mini-batch: the
        ``loop_phases`` payloads cross once per inner iteration."""
        by = self.bytes_by_phase
        once = sum(v for p, v in by.items() if p not in loop_phases)
        loop = sum(v for p, v in by.items() if p in loop_phases)
        return int(once + max(int(iters) - 1, 0) * loop)

    def reset(self) -> None:
        self._sigs.clear()


_CAST_CHUNK = 1 << 24      # elements a wire-cast pass takes at once


class LocalReducer:
    """N = 1 reducer: no communication, so ``psum`` records nothing.  Under
    ``compress`` the payload still takes the ``sync_dtype`` cast round
    trip, so an N = 1 run is numerically the N-shard run with the same
    sync dtype."""

    def __init__(self, meter: Optional[CommMeter] = None,
                 sync_dtype=torch.float32):
        self.meter = meter or CommMeter()
        self.sync_dtype = wire_dtype(sync_dtype)

    def psum(self, x: torch.Tensor, phase: str, compress: bool = True,
             dtype=None) -> torch.Tensor:
        wire = wire_dtype(dtype) if dtype is not None else self.sync_dtype
        if not compress or x.dtype == wire:
            return x
        # the round trip in passes: no full-size wire copy beside x and
        # the result
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        for src, dst in zip(x.reshape(-1).split(_CAST_CHUNK),
                            out.view(-1).split(_CAST_CHUNK)):
            dst.copy_(src.to(wire))
        return out

    def bill(self, x: torch.Tensor, phase: str) -> torch.Tensor:
        """Record a local full-statistic touch without reducing, as the
        reference's ``Reducer.bill``: the Robbins-Monro decay rescales the
        [W, K] statistic in place, memory traffic the byte meter bills
        once per mini-batch (``decay`` is not in ``LOOP_PHASES``).  Billed
        at the full W: scaling to the live vocabulary (the reference's
        ``w_rows``) comes with live-W runs (ROADMAP Queue 1, item 6).
        Returns ``x``."""
        self.meter.record(phase, x)
        return x


def topic_shards_unsupported(topic_shards: int) -> None:
    """Raise for a topic-sharded phi, which the port does not serve yet."""
    if int(topic_shards) != 1:
        raise NotImplementedError(
            f"topic_shards={topic_shards}: topic-sharded phi is not ported "
            f"yet (ROADMAP Queue 1, item 5: multi-shard sync)")
