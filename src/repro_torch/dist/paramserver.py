"""Pull-based power-slice parameter server of the port (counterpart of
``repro.dist.paramserver``, DESIGN.md §15).

Server shards own contiguous phi row ranges, and a worker

  (a) pushes deltas only for the rows its current mini-batch touched,
  (b) pulls only the rows its next mini-batch needs, prefetched one batch
      ahead so the pull overlaps the step, and
  (c) tolerates a bounded staleness ``S``: a pull for batch ``m`` may be
      served from a server state missing at most the last ``S`` committed
      pushes.  ``S = 0`` barriers every pull behind the previous push, so
      training follows the all-reduce backend.

Layering, as the reference's:

  - ``RowShards``      contiguous row ranges per server (metadata).
  - ``ParamServer``    the authoritative row-sharded [W, K] float32
                       statistic on the host (numpy; a lock a shard; a
                       committed-version counter and a condition variable
                       enforce the staleness bound), with the crash /
                       restart / replay state machine (DESIGN.md §17).
  - ``Transport``      one worker's link to the server shards.
                       ``SimTransport`` is the in-process threaded link
                       (optional per-op latency, per-link byte counters);
                       ``TorchDistributedTransport`` is the multi-host slot
                       over ``torch.distributed``: it checks for a process
                       group and refuses every op.
  - ``PSClient``       the worker's replica manager: keeps the full [W, K]
                       replica on the device that the unchanged POBP step
                       consumes, writes the pulled rows into it before a
                       batch and pushes the touched rows' delta after it.

Everything but ``PSClient.begin_batch`` / ``end_batch`` is host numpy.
Those two move the touched rows between the host and the replica: one
host-to-device copy of the pulled rows (then one indexed write, in place)
and one device-to-host copy of the updated rows, each through a pinned
host buffer when the replica is on a card, each timed by CUDA events.

The bfloat16 wire rounds float32 to nearest even on the bits (no
``ml_dtypes``): the bits equal the reference's ``astype(bfloat16)`` round
trip for every input, NaNs (quiet, sign kept) and subnormals included.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ROW_ID_BYTES = 4      # int32 row ids accompany every pushed/pulled slice
# the largest exponent of the retry backoff: ``2.0 ** 1024`` overflows a
# float, and every attempt below it sleeps what the reference sleeps
_MAX_BACKOFF_EXP = 1023
_WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2}


class TransportError(RuntimeError):
    """Base class for retryable transport failures: the op did not take
    effect (or its effect is unknown) and may be issued again; pushes are
    idempotent under the per-client sequence numbers (DESIGN.md §17)."""


class ServerUnavailableError(TransportError):
    """An op addressed a server shard that is currently down."""

    def __init__(self, server: int, detail: str = ""):
        self.server = int(server)
        super().__init__(f"server shard {server} is down"
                         + (f": {detail}" if detail else ""))


def wire_dtype_name(dtype) -> str:
    """'float32' or 'bfloat16' for a wire dtype given by name, as a torch
    dtype or as a numpy dtype (a caller's bfloat16 numpy dtype is taken by
    its name); anything else raises ``ValueError``."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).rsplit(".", 1)[-1]
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _WIRE_ITEMSIZE:
        raise ValueError(f"unknown wire dtype {dtype!r} (float32 or "
                         f"bfloat16)")
    return name


def bf16_round_trip(values: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 -> float32 on the bits: round to nearest even,
    a NaN to the quiet NaN of its sign (the reference's ``ml_dtypes``
    cast, bit for bit)."""
    bits = np.ascontiguousarray(values, np.float32).view(np.uint32)
    out = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    if nan.any():
        out[nan] = (bits[nan] & np.uint32(0x80000000)) | np.uint32(0x7FC00000)
    return out.view(np.float32)


# --------------------------------------------------------------------------
# row sharding metadata
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowShards:
    """Contiguous-range row ownership: server ``s`` owns rows
    ``[ranges[s][0], ranges[s][1])``, balanced to within one row, covering
    ``[0, w_cap)`` exactly."""

    w_cap: int
    num_servers: int

    def __post_init__(self):
        if self.num_servers < 1 or self.w_cap < 1:
            raise ValueError(f"need w_cap >= 1, num_servers >= 1, got "
                             f"({self.w_cap}, {self.num_servers})")

    @property
    def ranges(self) -> List[Tuple[int, int]]:
        base, rem = divmod(self.w_cap, self.num_servers)
        out, lo = [], 0
        for s in range(self.num_servers):
            hi = lo + base + (1 if s < rem else 0)
            out.append((lo, hi))
            lo = hi
        return out

    def owner(self, row: int) -> int:
        for s, (lo, hi) in enumerate(self.ranges):
            if lo <= row < hi:
                return s
        raise ValueError(f"row {row} outside [0, {self.w_cap})")

    def split(self, rows: np.ndarray) -> Dict[int, np.ndarray]:
        """Partition sorted unique ``rows`` into per-server id arrays; only
        servers with at least one row appear."""
        rows = np.asarray(rows, np.int64)
        out: Dict[int, np.ndarray] = {}
        for s, (lo, hi) in enumerate(self.ranges):
            sel = rows[(rows >= lo) & (rows < hi)]
            if sel.size:
                out[s] = sel
        return out


# --------------------------------------------------------------------------
# the authoritative server group
# --------------------------------------------------------------------------

class ParamServer:
    """Row-sharded owner of the accumulated [W, K] statistic.

    Pushes are deltas (adds); a batch push spans several shards and becomes
    visible through ``commit(version)``.  Pulls carry a ``min_version``
    and block until that many batch pushes have committed.  A push tagged
    ``(client_id, seq)`` applies at most once per shard lifetime;
    ``crash(s)`` loses a shard's rows and dedup memory, ``restart(s)``
    reloads the rows from the last ``mark_synced()`` snapshot and holds
    pulls from the shard until a client replays its retained deltas and
    calls ``mark_recovered(s)``.
    """

    def __init__(self, phi0: np.ndarray, num_servers: int = 1,
                 version: int = 0, pull_timeout: float = 60.0):
        phi0 = np.asarray(phi0, np.float32)
        self.shards = RowShards(phi0.shape[0], num_servers)
        self._phi = phi0.copy()
        self._locks = [threading.Lock() for _ in range(num_servers)]
        self._cv = threading.Condition()
        self._committed = int(version)
        self.pull_timeout = float(pull_timeout)
        self._down: set = set()           # crashed shard ids
        self._replaying: set = set()      # restarted, awaiting delta replay
        self._applied: List[Dict[str, set]] = [dict()
                                               for _ in range(num_servers)]
        # the last server-synced snapshot: what a restarted shard reloads
        self._sync_phi = phi0.copy()
        self._sync_version = int(version)
        self.duplicates_dropped = 0
        self.recovery_log: List[Dict[str, Any]] = []

    @property
    def committed(self) -> int:
        with self._cv:
            return self._committed

    def apply_push(self, server: int, rows: np.ndarray,
                   deltas: np.ndarray, client_id: Optional[str] = None,
                   seq: Optional[int] = None, replay: bool = False) -> bool:
        """Add a delta push to one shard; False when its ``(client_id,
        seq)`` tag was applied already.  A shard awaiting replay takes only
        replay pushes: a retry landing before the replayed backlog would
        add the rows in another order (float addition is not associative)."""
        with self._cv:
            if server in self._down:
                raise ServerUnavailableError(server, "push rejected")
            if server in self._replaying and not replay:
                raise ServerUnavailableError(
                    server, "shard replaying retained deltas; ordinary "
                            "pushes fenced until recovery")
        lo, hi = self.shards.ranges[server]
        rows = np.asarray(rows, np.int64)
        if rows.size and not ((rows >= lo) & (rows < hi)).all():
            raise ValueError(f"push to server {server} carries rows outside "
                             f"[{lo}, {hi})")
        with self._locks[server]:
            if client_id is not None and seq is not None:
                seen = self._applied[server].setdefault(client_id, set())
                if seq in seen:
                    self.duplicates_dropped += 1
                    return False
                seen.add(seq)
            np.add.at(self._phi, rows, np.asarray(deltas, np.float32))
        return True

    def commit(self, version: int) -> None:
        with self._cv:
            self._committed = max(self._committed, int(version))
            self._cv.notify_all()

    def serve_pull(self, server: int, rows: np.ndarray, min_version: int,
                   timeout: Optional[float] = None) -> Tuple[np.ndarray, int]:
        if timeout is None:
            timeout = self.pull_timeout
        lo, hi = self.shards.ranges[server]
        with self._cv:
            # ready, or down (wake to fail fast, so the client backs off
            # and recovers instead of waiting out the timeout)
            ok = self._cv.wait_for(
                lambda: (server in self._down
                         or (self._committed >= min_version
                             and server not in self._replaying)),
                timeout=timeout)
            if server in self._down:
                raise ServerUnavailableError(server, "pull rejected")
            if not ok:
                raise TimeoutError(
                    f"pull from server shard {server} (rows [{lo}, {hi})) "
                    f"waited {timeout}s for committed version "
                    f">= {min_version} (at {self._committed}"
                    + (", shard awaiting delta replay"
                       if server in self._replaying else "")
                    + "); a push was lost or never committed")
            version = self._committed
        rows = np.asarray(rows, np.int64)
        if rows.size and not ((rows >= lo) & (rows < hi)).all():
            raise ValueError(f"pull from server {server} asks rows outside "
                             f"[{lo}, {hi})")
        with self._locks[server]:
            return self._phi[rows].copy(), version

    # ---- crash / recovery state machine (DESIGN.md §17) ----
    def is_up(self, server: int) -> bool:
        with self._cv:
            return server not in self._down

    def needs_replay(self) -> frozenset:
        with self._cv:
            return frozenset(self._replaying)

    def crash(self, server: int) -> None:
        """Lose a shard: its rows and its dedup memory are gone; ops in
        flight see ``ServerUnavailableError``."""
        lo, hi = self.shards.ranges[server]
        with self._locks[server]:
            with self._cv:
                self._down.add(server)
                self._cv.notify_all()
            self._phi[lo:hi] = 0.0
            self._applied[server] = dict()
        self.recovery_log.append({"event": "crash", "server": int(server)})

    def restart(self, server: int) -> None:
        """Bring a crashed shard back from the last synced snapshot; it
        refuses pulls until a client replays (``mark_recovered``)."""
        lo, hi = self.shards.ranges[server]
        with self._locks[server]:
            self._phi[lo:hi] = self._sync_phi[lo:hi]
            with self._cv:
                self._down.discard(server)
                self._replaying.add(server)
                self._cv.notify_all()
        self.recovery_log.append({"event": "restart", "server": int(server),
                                  "restored_version": self._sync_version})

    def mark_recovered(self, server: int) -> None:
        with self._cv:
            self._replaying.discard(server)
            self._cv.notify_all()
        self.recovery_log.append({"event": "recovered",
                                  "server": int(server)})

    def mark_synced(self) -> None:
        """Checkpoint-fence handshake: the committed state is durable and
        becomes the restart base; clients may trim their replay logs
        (``PSClient.mark_durable``)."""
        for lock in self._locks:
            lock.acquire()
        try:
            with self._cv:
                self._sync_version = self._committed
            self._sync_phi = self._phi.copy()
        finally:
            for lock in self._locks:
                lock.release()

    # ---- checkpoint handshake: the server copy is the statistic a fence
    # persists and a resume rehydrates
    def snapshot(self) -> Tuple[np.ndarray, int]:
        with self._cv:
            version = self._committed
        for lock in self._locks:
            lock.acquire()
        try:
            return self._phi.copy(), version
        finally:
            for lock in self._locks:
                lock.release()

    def manifest(self) -> Dict[str, Any]:
        """The server side of the checkpoint manifest (``extra['ps']``);
        phi itself rides the checkpoint tree."""
        return {"num_servers": self.shards.num_servers,
                "w_cap": self.shards.w_cap,
                "ranges": [list(r) for r in self.shards.ranges],
                "version": self.committed}


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------

class Transport:
    """Worker <-> server-shard message layer.

    Safe to call from one worker thread; pulls return a ``Future`` so the
    client can prefetch.  Byte counters are per link (server shard and
    direction) and count the encoded payload: int32 row ids plus the
    values at the wire dtype.
    """

    wire_dtype = "float32"

    def __init__(self, num_servers: int):
        self.pushed_bytes = [0] * num_servers
        self.pulled_bytes = [0] * num_servers

    def push_batch(self, version: int, rows: np.ndarray,
                   deltas: np.ndarray, *, client_id: Optional[str] = None,
                   seq: Optional[int] = None,
                   replay: bool = False) -> Future:
        raise NotImplementedError

    def pull(self, rows: np.ndarray, min_version: int) -> Future:
        """-> Future[(values [len(rows), K], served_version)]."""
        raise NotImplementedError

    def servers_of(self, rows: np.ndarray) -> frozenset:
        """The server shards that own ``rows``: those an op on them
        addresses."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    # ---- recovery surface (no-ops for transports without failures) ----
    def needs_replay(self) -> frozenset:
        """Shard ids that restarted and await client delta replay."""
        return frozenset()

    def mark_recovered(self, server: int) -> None:
        pass

    def crash_server(self, server: int) -> None:
        raise NotImplementedError(f"{type(self).__name__} cannot inject "
                                  "server crashes")

    def restart_server(self, server: int) -> None:
        raise NotImplementedError(f"{type(self).__name__} cannot restart "
                                  "servers")

    # ---- shared accounting ----
    @property
    def wire_itemsize(self) -> int:
        return _WIRE_ITEMSIZE[wire_dtype_name(self.wire_dtype)]

    def _bill(self, counter: List[int], server: int, n_rows: int,
              k: int, itemsize: int) -> None:
        counter[server] += n_rows * (k * itemsize + _ROW_ID_BYTES)

    @property
    def total_bytes(self) -> int:
        return sum(self.pushed_bytes) + sum(self.pulled_bytes)

    def bytes_by_link(self) -> Dict[str, int]:
        out = {}
        for s, b in enumerate(self.pushed_bytes):
            out[f"push:s{s}"] = b
        for s, b in enumerate(self.pulled_bytes):
            out[f"pull:s{s}"] = b
        return out


class SimTransport(Transport):
    """In-process threaded transport over a live ``ParamServer``.

    ``latency_s`` delays each op (one way), so the prefetch overlap is
    measurable in one process; ``wire_dtype`` ('float32' or 'bfloat16',
    by name or as a torch or numpy dtype) is the value encoding on the
    wire: bfloat16 halves the value bytes, and the values take its round
    trip, so billed bytes and delivered precision agree.
    """

    def __init__(self, server: ParamServer, latency_s: float = 0.0,
                 wire_dtype="float32", max_workers: int = 4):
        super().__init__(server.shards.num_servers)
        self.server = server
        self.latency_s = float(latency_s)
        self.wire_dtype = wire_dtype_name(wire_dtype)
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="repro-ps")

    def _encode(self, values: np.ndarray) -> np.ndarray:
        if self.wire_dtype == "bfloat16":
            return bf16_round_trip(values)
        return np.asarray(values, np.float32)

    def _do_push(self, version, by_server, deltas, k, client_id, seq,
                 replay):
        if self.latency_s:
            time.sleep(self.latency_s)
        for s, (rows, idx) in by_server.items():
            # billed before it is applied: the payload crossed the wire
            # whether the shard dedupes it or is down
            self._bill(self.pushed_bytes, s, len(rows), k,
                       self.wire_itemsize)
            self.server.apply_push(s, rows, deltas[idx],
                                   client_id=client_id, seq=seq,
                                   replay=replay)
        self.server.commit(version)

    def push_batch(self, version: int, rows: np.ndarray,
                   deltas: np.ndarray, *, client_id: Optional[str] = None,
                   seq: Optional[int] = None,
                   replay: bool = False) -> Future:
        rows = np.asarray(rows, np.int64)
        deltas = self._encode(np.asarray(deltas))
        k = deltas.shape[1] if deltas.ndim == 2 else 1
        order = np.argsort(rows, kind="stable")
        rows_s, idx_s = rows[order], order
        by_server = {}
        for s, sel in self.server.shards.split(rows_s).items():
            mask = np.isin(rows_s, sel)
            by_server[s] = (rows_s[mask], idx_s[mask])
        return self._pool.submit(self._do_push, version, by_server, deltas,
                                 k, client_id, seq, replay)

    def _do_pull(self, by_server, n_rows, k, min_version):
        if self.latency_s:
            time.sleep(self.latency_s)
        out = np.zeros((n_rows, k), np.float32)
        version = min_version
        for s, (rows, idx) in by_server.items():
            vals, version = self.server.serve_pull(s, rows, min_version)
            out[idx] = self._encode(vals)
            self._bill(self.pulled_bytes, s, len(rows), k,
                       self.wire_itemsize)
        return out, version

    def pull(self, rows: np.ndarray, min_version: int) -> Future:
        rows = np.asarray(rows, np.int64)
        k = self.server._phi.shape[1]
        idx_all = np.arange(rows.size)
        by_server = {}
        for s, sel in self.server.shards.split(rows).items():
            mask = np.isin(rows, sel)
            by_server[s] = (rows[mask], idx_all[mask])
        return self._pool.submit(self._do_pull, by_server, rows.size, k,
                                 min_version)

    def servers_of(self, rows: np.ndarray) -> frozenset:
        return frozenset(self.server.shards.split(rows))

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    # ---- recovery surface: the live server group's ----
    def needs_replay(self) -> frozenset:
        return self.server.needs_replay()

    def mark_recovered(self, server: int) -> None:
        self.server.mark_recovered(server)

    def crash_server(self, server: int) -> None:
        self.server.crash(server)

    def restart_server(self, server: int) -> None:
        self.server.restart(server)


class TorchDistributedTransport(Transport):
    """Multi-host slot: the same push/pull contract over
    ``torch.distributed``.

    A checked stub: it refuses construction without a process group and
    refuses every op, so a cluster launch never seems to run multi-host
    while it runs in one process.
    """

    def __init__(self, num_servers: int):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "TorchDistributedTransport requires torch.distributed."
                "init_process_group() (init method + rank + world size) "
                "before construction; for single-host runs use "
                "SimTransport (--backend ps defaults to it)")
        super().__init__(num_servers)

    def push_batch(self, version, rows, deltas, **kw) -> Future:
        raise NotImplementedError(
            "multi-host PS push is the ROADMAP backlog head: encode "
            "(rows, deltas) per owning host and send over a "
            "torch.distributed side channel; SimTransport defines the "
            "contract this must satisfy (tests/test_torch_paramserver.py)")

    def pull(self, rows, min_version) -> Future:
        raise NotImplementedError(
            "multi-host PS pull is the ROADMAP backlog head; see "
            "push_batch")


# --------------------------------------------------------------------------
# the worker-side client
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _PushRec:
    """One issued delta push, kept until a checkpoint fence makes it
    durable: the unit of retry and of crash-recovery replay."""

    seq: int
    version: int
    rows: np.ndarray
    delta: np.ndarray
    future: Optional[Future] = None


class _Staging:
    """A grow-only pinned host buffer of float32 values, for the copies
    between the host and a card.  ``ready`` is the event of the last copy
    that read it: the buffer is not written again before it completes."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.ready: Optional[torch.cuda.Event] = None

    def take(self, shape) -> torch.Tensor:
        n = int(np.prod(shape))
        if self.ready is not None:
            self.ready.synchronize()
        if self.buf is None or self.buf.numel() < n:
            self.buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
        return self.buf[:n].view(*shape)


class PSClient:
    """Keeps one worker's full-capacity device replica fresh through
    touched-row pulls and emits touched-row delta pushes.

    The replica is what the unchanged POBP step consumes.  For batch ``m``
    (1-indexed):

      ``begin_batch(m, rows, phi)``  waits for the prefetched pull of
          ``rows`` (or pulls now), writes the pulled rows into ``phi`` in
          place and keeps them as the push's base; the wait is timed
          (``pull_wait_s``, the prefetch-overlap instrument).
      ``prefetch(m_next, rows_next)``  issues the next pull with
          ``min_version = m_next - 1 - S``: at S = 0 it waits server-side
          for this batch's push; at S > 0 a bounded-stale state serves it.
      ``end_batch(m, phi_new, rows)``  reads the updated rows back, pushes
          ``new - base`` as version ``m``, and keeps at most S pushes
          uncommitted.

    Chaos hardening (DESIGN.md §17), as the reference's: every push carries
    ``(client_id, seq)``; failed ops retry with exponential backoff and a
    deterministic jitter until ``retry_deadline_s``; every push since the
    last durable fence is retained, and when a restarted shard asks for
    replay the log is pushed again in version order.  Retry and replay
    bytes are billed into ``meter`` (``ps.retry.*``, ``ps.replay``).

    ``copies`` records, per batch, the touched rows and the two copies'
    times: ``h2d_ms`` / ``d2h_ms`` on the card (CUDA events around the
    copy and the indexed write or read; None off a card) and
    ``h2d_host_ms`` / ``d2h_host_ms`` on the host (the staging, the
    enqueue and, for the read, the wait for the values).
    """

    _RETRYABLE = (TransportError, TimeoutError)

    def __init__(self, transport: Transport, staleness: int = 0,
                 client_id: str = "w0", retry_deadline_s: float = 60.0,
                 backoff0_s: float = 0.01, backoff_max_s: float = 0.5,
                 meter=None):
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        self.transport = transport
        self.staleness = int(staleness)
        self.client_id = str(client_id)
        self.retry_deadline_s = float(retry_deadline_s)
        self.backoff0_s = float(backoff0_s)
        self.backoff_max_s = float(backoff_max_s)
        self.meter = meter
        self.pull_wait_s = 0.0
        self.push_wait_s = 0.0
        self.touched_history: List[int] = []
        self.retries = 0
        self.replayed_pushes = 0
        self.recoveries = 0
        self.retry_wire_bytes = 0
        self._prefetched: Optional[Tuple[int, np.ndarray, Future]] = None
        self._base_rows: Optional[np.ndarray] = None       # pulled values
        self._k: Optional[int] = None                      # replica width
        self._pending: List[_PushRec] = []
        self._retained: List[_PushRec] = []   # since the last durable fence
        self._seq = 0
        self._retry_counter = 0
        self._jitter_key = zlib.crc32(self.client_id.encode())
        self._stage_in, self._stage_out = _Staging(), _Staging()
        self._h2d: Optional[Dict[str, Any]] = None
        self.copies: List[Dict[str, Any]] = []

    # -- helpers ----------------------------------------------------------
    def _min_version(self, m: int) -> int:
        return max(0, m - 1 - self.staleness)

    def _op_nbytes(self, rows: np.ndarray, k: int) -> int:
        return int(rows.size) * (k * self.transport.wire_itemsize
                                 + _ROW_ID_BYTES)

    def _bill_retry(self, phase: str, nbytes: int) -> None:
        self.retry_wire_bytes += nbytes
        if self.meter is not None:
            self.meter.record_host(phase, nbytes)

    def _backoff(self, attempt: int) -> None:
        """Exponential backoff with a deterministic jitter: retry ``n`` of
        this client sleeps a pure function of ``(client_id, retry
        counter)``.  The exponent stops at 1023, where ``2.0 ** attempt``
        would overflow; below it the sleep is the reference's."""
        base = min(self.backoff_max_s,
                   self.backoff0_s * (2.0 ** min(attempt, _MAX_BACKOFF_EXP)))
        rng = np.random.default_rng((self._jitter_key, self._retry_counter))
        self._retry_counter += 1
        time.sleep(base * (0.5 + rng.random()))

    # -- retry / recovery core --------------------------------------------
    def _recover_if_needed(self) -> None:
        """If a shard restarted and awaits replay, push the retained
        post-fence deltas again in version order, then lift its barrier.
        Dedup makes the replay a no-op on healthy shards."""
        need = sorted(self.transport.needs_replay())
        if not need:
            return
        self.recoveries += len(need)
        for rec in self._retained:
            k = rec.delta.shape[1] if rec.delta.ndim == 2 else 1
            self._bill_retry("ps.replay", self._op_nbytes(rec.rows, k))
            # replay=True: the replaying shard fences ordinary pushes, so
            # the backlog re-applies in version order before any retry
            fut = self.transport.push_batch(rec.version, rec.rows, rec.delta,
                                            client_id=self.client_id,
                                            seq=rec.seq, replay=True)
            t0, attempt = time.time(), 0
            while True:
                try:
                    fut.result()
                    break
                except self._RETRYABLE as e:
                    if time.time() - t0 > self.retry_deadline_s:
                        raise TimeoutError(
                            f"replay of push seq {rec.seq} (version "
                            f"{rec.version}) exceeded retry deadline "
                            f"{self.retry_deadline_s}s: {e}") from e
                    self._backoff(attempt)
                    attempt += 1
                    self.retries += 1
                    self._bill_retry("ps.replay",
                                     self._op_nbytes(rec.rows, k))
                    fut = self.transport.push_batch(
                        rec.version, rec.rows, rec.delta,
                        client_id=self.client_id, seq=rec.seq, replay=True)
            self.replayed_pushes += 1
        for s in need:
            self.transport.mark_recovered(s)

    def _await_push(self, rec: _PushRec) -> None:
        t0, attempt = time.time(), 0
        while True:
            try:
                rec.future.result()
                return
            except self._RETRYABLE as e:
                self._recover_if_needed()
                if time.time() - t0 > self.retry_deadline_s:
                    raise TimeoutError(
                        f"push seq {rec.seq} (version {rec.version}) by "
                        f"client {self.client_id!r} exceeded retry deadline "
                        f"{self.retry_deadline_s}s: {e}") from e
                self._backoff(attempt)
                attempt += 1
                self.retries += 1
                k = rec.delta.shape[1] if rec.delta.ndim == 2 else 1
                self._bill_retry("ps.retry.push",
                                 self._op_nbytes(rec.rows, k))
                rec.future = self.transport.push_batch(
                    rec.version, rec.rows, rec.delta,
                    client_id=self.client_id, seq=rec.seq)

    def _repair_pending(self) -> None:
        """Issue again any in-flight push whose future already failed (a
        pull timeout often follows from our own dropped push)."""
        for rec in self._pending:
            if rec.future.done() and rec.future.exception() is not None:
                exc = rec.future.exception()
                if not isinstance(exc, self._RETRYABLE):
                    continue
                self.retries += 1
                k = rec.delta.shape[1] if rec.delta.ndim == 2 else 1
                self._bill_retry("ps.retry.push",
                                 self._op_nbytes(rec.rows, k))
                rec.future = self.transport.push_batch(
                    rec.version, rec.rows, rec.delta,
                    client_id=self.client_id, seq=rec.seq)

    def _pull_with_retry(self, rows: np.ndarray, min_version: int,
                         fut: Optional[Future] = None):
        if fut is None:
            fut = self.transport.pull(rows, min_version)
        t0, attempt = time.time(), 0
        while True:
            try:
                return fut.result()
            except self._RETRYABLE as e:
                self._recover_if_needed()
                self._repair_pending()
                if time.time() - t0 > self.retry_deadline_s:
                    raise TimeoutError(
                        f"pull (min_version {min_version}, {rows.size} "
                        f"rows) by client {self.client_id!r} exceeded retry "
                        f"deadline {self.retry_deadline_s}s: {e}") from e
                self._backoff(attempt)
                attempt += 1
                self.retries += 1
                self._bill_retry("ps.retry.pull",
                                 self._op_nbytes(rows, self._k or 1))
                fut = self.transport.pull(rows, min_version)

    def prefetch(self, m_next: int, rows_next: np.ndarray) -> None:
        if self._prefetched is not None:
            # a stale prefetch is drained, not leaked
            self._prefetched[2].result()
        rows_next = np.asarray(rows_next, np.int64)
        self._prefetched = (m_next, rows_next,
                            self.transport.pull(rows_next,
                                                self._min_version(m_next)))

    # -- the replica's copies ---------------------------------------------
    def _write_rows(self, phi: torch.Tensor, rows: np.ndarray,
                    vals: np.ndarray) -> Dict[str, Any]:
        """``phi[rows] = vals`` in place, cast to phi's dtype (round to
        nearest for bfloat16): on a card one host-to-device copy through
        the pinned buffer and one indexed write, timed by events."""
        t0 = time.perf_counter()
        if phi.device.type != "cuda":
            phi.index_copy_(0, torch.from_numpy(rows), torch.from_numpy(
                np.ascontiguousarray(vals, np.float32)).to(phi.dtype))
            return {"host_ms": (time.perf_counter() - t0) * 1e3}
        host = self._stage_in.take(vals.shape)
        host.numpy()[...] = vals
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        src = host.to(phi.device, non_blocking=True)
        self._stage_in.ready = torch.cuda.Event()
        self._stage_in.ready.record()
        idx = torch.from_numpy(rows).to(phi.device)
        phi.index_copy_(0, idx, src.to(phi.dtype))
        ev[1].record()
        return {"host_ms": (time.perf_counter() - t0) * 1e3, "events": ev}

    def _read_rows(self, phi: torch.Tensor, rows: np.ndarray):
        """(``phi[rows]`` as float32 on the host, the copy's record): on a
        card one indexed read and one device-to-host copy into the pinned
        buffer, timed by events."""
        t0 = time.perf_counter()
        if phi.device.type != "cuda":
            got = phi.index_select(0, torch.from_numpy(rows)).float().numpy()
            return got, {"host_ms": (time.perf_counter() - t0) * 1e3}
        idx = torch.from_numpy(rows).to(phi.device)
        host = self._stage_out.take((rows.size,) + tuple(phi.shape[1:]))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        host.copy_(phi.index_select(0, idx).float(), non_blocking=True)
        ev[1].record()
        ev[1].synchronize()
        return host.numpy(), {"host_ms": (time.perf_counter() - t0) * 1e3,
                              "events": ev}

    def _log_copies(self, rows: np.ndarray, d2h: Dict[str, Any]) -> None:
        rec = {"rows": int(rows.size)}
        for leg, got in (("h2d", self._h2d), ("d2h", d2h)):
            got = got or {}
            ev = got.get("events")
            rec[f"{leg}_ms"] = None if ev is None else ev[0].elapsed_time(ev[1])
            rec[f"{leg}_host_ms"] = got.get("host_ms")
        self._h2d = None
        self.copies.append(rec)

    # -- the batch protocol -----------------------------------------------
    def begin_batch(self, m: int, rows: np.ndarray, phi: torch.Tensor):
        """Write the server's ``rows`` into the replica ``phi`` (in place;
        returned for the reference's call pattern)."""
        rows = np.asarray(rows, np.int64)
        t0 = time.time()
        if (self._prefetched is not None and self._prefetched[0] == m
                and np.array_equal(self._prefetched[1], rows)):
            vals, _ = self._pull_with_retry(rows, self._min_version(m),
                                            fut=self._prefetched[2])
        else:
            if self._prefetched is not None:
                try:                             # drain a mismatched pull
                    self._prefetched[2].result()
                except self._RETRYABLE:
                    pass                         # value unused; not retried
            vals, _ = self._pull_with_retry(rows, self._min_version(m))
        self._prefetched = None
        self.pull_wait_s += time.time() - t0
        self.touched_history.append(int(rows.size))
        self._base_rows = vals
        if vals.ndim == 2:
            self._k = int(vals.shape[1])
        self._h2d = self._write_rows(phi, rows, vals) if rows.size else None
        return phi

    def end_batch(self, m: int, phi_new: torch.Tensor,
                  rows: np.ndarray) -> None:
        """Push this batch's touched-row delta as version ``m``."""
        rows = np.asarray(rows, np.int64)
        if rows.size:
            new_rows, d2h = self._read_rows(phi_new, rows)
        else:
            new_rows, d2h = np.zeros((0,) + tuple(phi_new.shape[1:]),
                                     np.float32), None
        if self._base_rows is None or self._base_rows.shape != new_rows.shape:
            raise RuntimeError("end_batch without a matching begin_batch")
        delta = new_rows - self._base_rows
        self._base_rows = None
        self._log_copies(rows, d2h)
        rec = _PushRec(seq=self._seq, version=m, rows=rows, delta=delta)
        self._seq += 1
        rec.future = self.transport.push_batch(
            m, rows, delta, client_id=self.client_id, seq=rec.seq)
        # retained until the next durable fence: the replay source
        self._retained.append(rec)
        self._pending.append(rec)
        # bounded staleness also bounds the worker's memory: at most S
        # pushes may stay uncommitted
        t0 = time.time()
        while len(self._pending) > self.staleness:
            self._await_push(self._pending.pop(0))
        self.push_wait_s += time.time() - t0

    def flush(self) -> None:
        """Commit every outstanding push (checkpoint fences, shutdown)."""
        while self._pending:
            self._await_push(self._pending.pop(0))
        if self._prefetched is not None:
            try:
                self._prefetched[2].result()
            except self._RETRYABLE:
                pass          # value unused; the next begin_batch pulls
            self._prefetched = None

    def mark_durable(self) -> None:
        """Checkpoint-fence handshake: the retained pushes are covered by a
        synced snapshot (``ParamServer.mark_synced``); trim the log."""
        self._retained.clear()

    @property
    def mean_touched_rows(self) -> float:
        if not self.touched_history:
            return 0.0
        return float(np.mean(self.touched_history))

    def stats(self) -> Dict[str, Any]:
        return {"pull_wait_s": self.pull_wait_s,
                "push_wait_s": self.push_wait_s,
                "mean_touched_rows": self.mean_touched_rows,
                "wire_bytes": self.transport.total_bytes,
                "bytes_by_link": self.transport.bytes_by_link(),
                "retries": self.retries,
                "replayed_pushes": self.replayed_pushes,
                "recoveries": self.recoveries,
                "retry_wire_bytes": self.retry_wire_bytes,
                "retained_pushes": len(self._retained)}


def touched_rows_of(word_ids, counts) -> np.ndarray:
    """Sorted unique vocabulary rows a mini-batch touches (padding slots
    carry zero counts and never count), from its host arrays ([D, L] or
    [N, Dl, L], numpy or CPU tensors).  A tensor on a card raises: the
    rows are read before the batch is uploaded, never back from it."""
    for x in (word_ids, counts):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            raise ValueError(f"touched_rows_of reads the batch's host "
                             f"arrays, got a tensor on {x.device}")
    wid = np.asarray(word_ids).reshape(-1)
    cnt = np.asarray(counts).reshape(-1)
    return np.unique(wid[cnt > 0]).astype(np.int64)


def sliced_sum(deltas_by_shard: Sequence[np.ndarray],
               touched_by_shard: Sequence[np.ndarray],
               w_cap: int) -> np.ndarray:
    """The sum a server group computes: each shard adds only its touched
    rows, in shard order.  When each shard's dense delta is zero off its
    touched rows (POBP's token-scatter payloads), this equals the dense
    all-reduce bit for bit."""
    k = deltas_by_shard[0].shape[1]
    out = np.zeros((w_cap, k), deltas_by_shard[0].dtype)
    for delta, touched in zip(deltas_by_shard, touched_by_shard):
        touched = np.asarray(touched, np.int64)
        out[touched] += np.asarray(delta)[touched]
    return out
