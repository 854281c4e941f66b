"""Stream-lifecycle transitions of the phi statistic: grow, shrink, compact
and recycle (the counterpart of ``repro.core.lifecycle``).

  - `resize_state`: the capacity-ladder resize.  Growing pads zero guard
    rows (no word maps to them yet, so the trajectory does not change);
    shrinking cuts guard rows only and runs at a checkpoint fence, which
    the caller shows by passing the live vocabulary size.  A shrink returns
    a tensor of its own, so the old rung's storage is freed once the old
    state goes.
  - `apply_row_remap`: moves phi rows by a ``VocabMap.compact`` remap on
    the tensor's device (survivors to a dense prefix, dead and vacated rows
    zero).
  - `dead_rows`: a row is reclaimable when it has been idle for
    ``min_idle`` batches AND its decayed statistic is at or under a mass
    floor; both are functions of the consumed prefix, so one stream with
    one fence schedule reclaims the same rows every time.
  - `dead_topics` / `recycle_topics`: topic columns whose live mass has
    faded are reseeded from the rows the model explains worst.

The last three run on the host with numpy, as the reference's do, after
the fence has drained the stream.  Every destructive transition (shrink,
remap, recycle) runs only at a fence, and the driver saves the new state,
vocabulary and remap right after it, so a crash on either side resumes onto
a consistent (phi, vocabulary) pair.  ``m`` and the generator are never
touched.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import LDATrainState


def resize_state(state: LDATrainState, new_vocab_cap: int,
                 live_w: Optional[int] = None) -> LDATrainState:
    """The state at capacity ``new_vocab_cap`` (the same state when the
    rung is unchanged).

    Grow: zero guard rows padded on (a new tensor).  Shrink: only guard
    rows may go, so ``live_w`` (the live vocabulary at the fence the shrink
    runs under) is required, and the new rung must stay strictly above it;
    the kept rows are copied into a tensor of their own, so the old rung's
    storage is not pinned by a view and is freed with the old state.
    """
    W, K = state.phi_acc.shape
    if new_vocab_cap == W:
        return state
    phi = state.phi_acc
    if new_vocab_cap > W:
        phi = torch.cat([phi, phi.new_zeros((new_vocab_cap - W, K))], dim=0)
        return LDATrainState(phi_acc=phi, m=state.m,
                             generator=state.generator)
    if live_w is None:
        raise ValueError(
            f"cannot shrink phi capacity {W} -> {new_vocab_cap} without a "
            f"fence: pass live_w (shrink is checkpoint-fenced — only guard "
            f"rows above the live vocabulary may be cut; DESIGN.md §14)")
    if new_vocab_cap <= live_w:
        raise ValueError(
            f"cannot shrink phi capacity {W} -> {new_vocab_cap} with "
            f"live_w={live_w}: the new rung must stay strictly above the "
            f"live vocabulary (guard-row invariant, DESIGN.md §12)")
    return LDATrainState(phi_acc=phi[:new_vocab_cap].clone(), m=state.m,
                         generator=state.generator)


def apply_row_remap(state: LDATrainState, remap) -> LDATrainState:
    """Move phi rows by a compaction remap (``VocabMap.compact``):
    ``remap[i]`` is row i's new row, or -1 for a reclaimed row.  Survivors
    land at ``phi_new[remap[i]] = phi[i]``; every other row (the reclaimed
    rows and the tail the survivors vacated) is zero, a guard row again.
    Capacity is unchanged: pair it with `resize_state` to drop a rung.  One
    scatter on phi's device into a new tensor; the destinations are
    distinct, so it is exact and deterministic."""
    phi = state.phi_acc
    remap = torch.as_tensor(np.asarray(remap, np.int64), device=phi.device)
    if remap.shape[0] > phi.shape[0]:
        raise ValueError(f"remap covers {remap.shape[0]} rows but phi has "
                         f"only {phi.shape[0]}")
    keep = (remap >= 0).nonzero().squeeze(1)
    out = torch.zeros_like(phi)
    out[remap[keep]] = phi[keep]
    return LDATrainState(phi_acc=out, m=state.m, generator=state.generator)


def dead_rows(row_mass, last_touched, step: int, min_idle: int,
              mass_floor: float) -> np.ndarray:
    """bool[live] mask of the rows reclaimable at fence ``step``: untouched
    by every batch of the last ``min_idle`` AND with a statistic at or
    under ``mass_floor`` (absolute units; callers scale it from K*beta).
    Without decay an idle row keeps its mass, and the second test never
    fires."""
    idle = (step - np.asarray(last_touched)) >= int(min_idle)
    return idle & (np.asarray(row_mass) <= float(mass_floor))


def dead_topics(phi: np.ndarray, live_w: int, tol: float) -> np.ndarray:
    """Topic columns whose live mass is at or under ``tol`` x the mean
    topic mass."""
    mass_k = np.asarray(phi[:live_w], np.float64).sum(axis=0)
    return np.nonzero(mass_k <= float(tol) * max(mass_k.mean(), 1e-30))[0]


def recycle_topics(phi: np.ndarray, live_w: int, tol: float,
                   seed_frac: float = 0.1) -> Tuple[np.ndarray, List[int]]:
    """Reseed the `dead_topics` of host ``phi`` [W, K] from the rows the
    model explains worst: each live row's residual mass (its mass less its
    largest topic's) ranks the rows, and each dead column gets
    ``seed_frac`` of the top rows' residual (a stable argsort: ties by
    row).  Returns (new phi, recycled topics); ``phi`` itself, unchanged,
    when no topic is dead."""
    dead = dead_topics(phi, live_w, tol)
    if dead.size == 0:
        return phi, []
    live = np.asarray(phi[:live_w], np.float32)
    row_mass = live.sum(axis=1)
    residual = row_mass - live.max(axis=1)
    n_seed = max(8, live_w // 20)
    top = np.argsort(-residual, kind="stable")[:n_seed]
    out = np.array(phi, np.float32, copy=True)
    for k in dead:
        out[top, k] = seed_frac * residual[top]
    return out, [int(k) for k in dead]


__all__ = ["resize_state", "apply_row_remap", "dead_rows", "dead_topics",
           "recycle_topics"]
