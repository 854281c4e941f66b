"""Deterministic fault injection for the parameter-server transport of the
port (counterpart of ``repro.dist.faults``, DESIGN.md §17).

The clean ``SimTransport`` assumes links never drop, servers never die.
Production does not.  This module makes every failure scenario a
*reproducible test fixture*:

  - ``FaultPlan``       a pure, seed-keyed description of what goes wrong:
                        per-op drop / duplicate / delay probabilities,
                        partition windows in op-index space, and one
                        scheduled server crash + restart.  Every decision
                        is a counter-keyed hash of ``(seed, kind, index)``
                        — no hidden RNG state, so replaying the same op
                        sequence replays the same faults bit-for-bit.
  - ``ChaosTransport``  wraps ANY ``Transport`` and applies the plan at
                        the issue boundary: a dropped op returns a future
                        that raises ``FaultInjectedError`` (the payload
                        never reached a server), a duplicated push is
                        delivered twice (exercising the server's
                        sequence-number dedup), a delayed op sleeps at
                        issue, and the scheduled crash/restart calls
                        through to the inner transport's server hooks.

The hardened ``PSClient`` retry layer (exponential backoff + jitter +
deadline, retained-delta replay after a shard restart) is what makes
training *survive* a plan; at ``--staleness 0`` the committed phi under
any eventually-delivering plan is bit-exact with the clean run, because
every push is applied exactly once (sequence-number idempotence) in the
same version order (``tests/test_torch_faults.py`` pins this).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dist.paramserver import (ServerUnavailableError, Transport,
                                          TransportError)

_KIND_ID = {"push": 1, "pull": 2}


class FaultInjectedError(TransportError):
    """An op was dropped (or issued into a partition window) by a
    ``FaultPlan``.  Retryable: the payload never reached any server."""


def _decision_bits(seed: int, kind: str, index: int) -> np.ndarray:
    """Three uniform [0, 1) draws keyed purely by (seed, kind, index) —
    replaying op `index` replays its fate."""
    rng = np.random.default_rng((int(seed), _KIND_ID[kind], int(index)))
    return rng.random(3)


@dataclasses.dataclass(frozen=True)
class Decision:
    drop: bool = False
    duplicate: bool = False
    delay_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-replayable fault schedule.

    Probabilities are per *op attempt* (a retry of a dropped push is a
    new op index with its own draw, so an eventually-delivering plan
    needs only ``drop < 1``).  ``partitions`` are half-open windows
    ``(kind, lo, hi)`` in per-kind op-index space during which every op
    of that kind fails — a worker partitioned from the cluster.
    ``crash_server``/``crash_at_push`` schedule one server loss when the
    push op counter reaches the index; ``restart_after_pushes`` later
    the server restarts from its last synced snapshot and waits for
    client delta replay.  A worker blocked on a pull from the downed
    shard issues no pushes, so ``restart_after_pushes`` pulls addressed
    to that shard with no push between them also bring the restart (the
    reference counts pushes only, and such a worker waits out its retry
    deadline).
    """

    seed: int = 0
    drop_push: float = 0.0
    drop_pull: float = 0.0
    dup_push: float = 0.0
    delay_s: float = 0.0
    delay_prob: float = 0.0
    partitions: Tuple[Tuple[str, int, int], ...] = ()
    crash_server: Optional[int] = None
    crash_at_push: Optional[int] = None
    restart_after_pushes: int = 2

    def __post_init__(self):
        for p, name, hi in ((self.drop_push, "drop_push", 1.0),
                            (self.drop_pull, "drop_pull", 1.0),
                            (self.dup_push, "dup_push", 1.0 + 1e-9),
                            (self.delay_prob, "delay_prob", 1.0 + 1e-9)):
            if not 0.0 <= p < hi:
                # drop probabilities must stay < 1: retries draw fresh
                # fates, so eventual delivery needs a nonzero pass rate
                raise ValueError(f"{name} must be in [0, 1) for drops / "
                                 f"[0, 1] otherwise, got {p}")
        if (self.crash_server is None) != (self.crash_at_push is None):
            raise ValueError("crash_server and crash_at_push must be set "
                             "together")
        for kind, lo, hi in self.partitions:
            if kind not in _KIND_ID or hi <= lo:
                raise ValueError(f"bad partition window {(kind, lo, hi)}")

    @property
    def active(self) -> bool:
        return bool(self.drop_push or self.drop_pull or self.dup_push
                    or self.delay_prob or self.partitions
                    or self.crash_server is not None)

    def partitioned(self, kind: str, index: int) -> bool:
        return any(k == kind and lo <= index < hi
                   for k, lo, hi in self.partitions)

    def decide(self, kind: str, index: int) -> Decision:
        """The fate of the `index`-th op of `kind` — a pure function."""
        if self.partitioned(kind, index):
            return Decision(drop=True)
        r = _decision_bits(self.seed, kind, index)
        drop_p = self.drop_push if kind == "push" else self.drop_pull
        drop = bool(r[0] < drop_p)
        dup = bool(kind == "push" and not drop and r[1] < self.dup_push)
        delay = self.delay_s if r[2] < self.delay_prob else 0.0
        return Decision(drop=drop, duplicate=dup, delay_s=delay)

    @staticmethod
    def parse_crash(spec: str) -> Tuple[Optional[int], Optional[int]]:
        """``"SERVER@PUSHOP"`` (e.g. ``"1@6"``) -> (server, push op index);
        empty string -> (None, None)."""
        if not spec:
            return None, None
        try:
            server, at = spec.split("@")
            return int(server), int(at)
        except ValueError:
            raise ValueError(
                f"--chaos-crash expects SERVER@PUSHOP (e.g. '1@6'), "
                f"got {spec!r}") from None


def _failed_future(exc: Exception) -> Future:
    f: Future = Future()
    f.set_exception(exc)
    return f


class ChaosTransport(Transport):
    """Fault-injecting wrapper over any ``Transport``.

    Byte counters delegate to the inner transport, so the *measured*
    wire truth includes retry and duplicate overhead.  ``events`` is the
    replayable audit log the
    recovery gates read (drop / duplicate / crash / restart entries with
    their op indices).
    """

    def __init__(self, inner: Transport, plan: FaultPlan):
        super().__init__(len(inner.pushed_bytes))
        self.inner = inner
        self.plan = plan
        self.events: List[Dict[str, Any]] = []
        self._push_idx = 0
        self._pull_idx = 0
        self._crashed = False
        self._restarted = False
        self._stalled_pulls = 0    # pulls to the downed shard since a push
        self._dup_futures: List[Future] = []

    # ---- delegated accounting / recovery surface ----
    @property
    def total_bytes(self) -> int:
        return self.inner.total_bytes

    def bytes_by_link(self) -> Dict[str, int]:
        return self.inner.bytes_by_link()

    @property
    def wire_dtype(self):
        return self.inner.wire_dtype

    def needs_replay(self):
        return self.inner.needs_replay()

    def mark_recovered(self, server: int) -> None:
        self.inner.mark_recovered(server)

    def crash_server(self, server: int) -> None:
        self.inner.crash_server(server)

    def restart_server(self, server: int) -> None:
        self.inner.restart_server(server)

    # ---- the scheduled crash/restart state machine ----
    def _tick_crash_schedule(self, push_index: int) -> None:
        plan = self.plan
        if plan.crash_server is None:
            return
        if not self._crashed and push_index >= plan.crash_at_push:
            self._crashed = True
            self.inner.crash_server(plan.crash_server)
            self.events.append({"event": "crash", "server": plan.crash_server,
                                "push_op": push_index})
        elif (self._crashed and not self._restarted and push_index
              >= plan.crash_at_push + plan.restart_after_pushes):
            self._restarted = True
            self.inner.restart_server(plan.crash_server)
            self.events.append({"event": "restart",
                                "server": plan.crash_server,
                                "push_op": push_index})

    # ---- the op surface ----
    def _stalled_pull(self, pull_index: int, rows: np.ndarray) -> bool:
        """Whether pull `pull_index` on ``rows`` brings the scheduled
        restart: it addresses the downed shard, and it is the
        ``restart_after_pushes``-th such pull with no push between.  The
        shard then restarts and the pull fails as the downed shard would
        have failed it, so the client replays its deltas and pulls again.
        Keyed by op indices alone, so the event log replays."""
        plan = self.plan
        if (not self._crashed or self._restarted
                or plan.crash_server not in self.inner.servers_of(rows)):
            return False
        self._stalled_pulls += 1
        if self._stalled_pulls < plan.restart_after_pushes:
            return False
        self._restarted = True
        self.inner.restart_server(plan.crash_server)
        self.events.append({"event": "restart", "server": plan.crash_server,
                            "pull_op": pull_index})
        return True

    def push_batch(self, version: int, rows: np.ndarray,
                   deltas: np.ndarray, *, client_id: Optional[str] = None,
                   seq: Optional[int] = None,
                   replay: bool = False) -> Future:
        i = self._push_idx
        self._push_idx += 1
        self._stalled_pulls = 0
        self._tick_crash_schedule(i)
        d = self.plan.decide("push", i)
        if d.delay_s:
            time.sleep(d.delay_s)
        if d.drop:
            self.events.append({"event": "drop", "op": "push", "index": i,
                                "version": int(version)})
            return _failed_future(FaultInjectedError(
                f"push op {i} (version {version}, seq {seq}) dropped by "
                f"fault plan seed={self.plan.seed}"))
        fut = self.inner.push_batch(version, rows, deltas,
                                    client_id=client_id, seq=seq,
                                    replay=replay)
        if d.duplicate:
            self.events.append({"event": "duplicate", "op": "push",
                                "index": i, "version": int(version)})
            dup = self.inner.push_batch(version, rows, deltas,
                                        client_id=client_id, seq=seq,
                                        replay=replay)
            # retrieve the duplicate's outcome so a dup delivered into a
            # down server never surfaces as an unretrieved-exception leak
            dup.add_done_callback(lambda f: f.exception())
            self._dup_futures.append(dup)
        return fut

    def pull(self, rows: np.ndarray, min_version: int) -> Future:
        i = self._pull_idx
        self._pull_idx += 1
        d = self.plan.decide("pull", i)
        if d.delay_s:
            time.sleep(d.delay_s)
        if d.drop:
            self.events.append({"event": "drop", "op": "pull", "index": i,
                                "min_version": int(min_version)})
            return _failed_future(FaultInjectedError(
                f"pull op {i} (min_version {min_version}) dropped by fault "
                f"plan seed={self.plan.seed}"))
        if self._stalled_pull(i, rows):
            return _failed_future(ServerUnavailableError(
                self.plan.crash_server, "pull rejected"))
        return self.inner.pull(rows, min_version)

    def event_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e["event"]] = out.get(e["event"], 0) + 1
        return out

    def close(self) -> None:
        for f in self._dup_futures:
            try:
                f.result()
            except TransportError:
                pass
        self.inner.close()
