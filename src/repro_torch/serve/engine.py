"""Serving engines (counterpart of ``repro.serve.engine``): the paper's
train-once / fold-in-forever deployment as a request loop.

  - `SlabEngine` — continuous batching.  A fixed [slots, slot_len]
    in-flight slab holds one live document per slot; each step advances
    every slot a few fold-in sweeps, retires the converged and refills
    freed slots from the queue.  On top: a per-tenant theta cache, an OOV
    retraining trigger, SLO shedding and NaN/Inf quarantine.
  - `FoldInEngine` — bucket-ladder admission: requests queue per length
    bucket and run when ``batch_docs`` have gathered (or on flush).

Both run on one device (``device``, default ``"cuda"``).  With
``topic_shards > 1`` they serve a topic-sharded phi ([N, W, K/N], the
reference's model-axis simulation): its model psums are metered, per
request batch (bucket engine) or per retired document (slab engine).
The slab step never waits for the card: each step's outputs are copied
into pinned host buffers behind a ``torch.cuda.Event``, and ``_harvest``
reads a step only once its event has completed (or, once ``pipeline``
steps are in flight, waits for the oldest).

Placed on a mesh (phi a ``DTensor`` whose topics are split over the
``model`` axis of M ranks, as ``from_checkpoint(sharding=(mesh,
dist.sharding.phi_serving_spec(mesh, phi)))`` restores it), an engine is
one process of M that run in step (SPMD): each rank keeps only its [W',
K/M] topic block and folds in on it, the normalizer and residual sums
all-reduce over the model group, and each result's theta blocks are
all-gathered into [D, K], so every rank returns every result whole.
Every rank must submit the same requests in the same order.  A mesh
with no ``model`` axis, or one of size 1, replicates phi: the engine
then serves it as an unplaced one.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import Counter, deque
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import infer, perplexity
from repro_torch.core.device import resolve_device
from repro_torch.core.sync import wire_dtype
from repro_torch.core.types import LDAConfig
from repro_torch.data.batching import bucket_len, docs_to_padded, slab_refill
from repro_torch.serve.cache import ThetaCache, doc_digest

_EMPTY_DOC = (np.zeros(1, np.int32), np.zeros(1, np.float32))


@dataclasses.dataclass
class ServeResult:
    """One served request: the topic mixture plus serving diagnostics."""

    req_id: int
    theta: np.ndarray              # [K] normalized topic mixture
    latency_s: float               # submit -> result ready
    bucket: int                    # L bucket / slab slot that admitted it
    iters: int                     # fold-in sweeps run (0 for a cache hit)
    mean_r: float                  # residual at exit (per-doc on the slab)
    oov_tokens: float = 0.0        # token mass folded in via the OOV row
    phi_version: int = 0           # phi generation that served it
    comm_bytes: float = 0.0        # sync bytes billed to this request
    cached: bool = False           # served straight from the theta cache
    tenant: Optional[Hashable] = None
    error: Optional[str] = None    # "nonfinite_input" / "nonfinite_theta"


@dataclasses.dataclass
class Shed:
    """A typed admission rejection: the queue would blow the SLO deadline.
    Returned by ``SlabEngine.submit`` when ``admission_slo_s`` is set."""

    req_id: int
    est_wait_s: float
    slo_s: float
    queue_depth: int
    tenant: Optional[Hashable] = None


def _prepare_phi(phi_acc, cfg: LDAConfig, live_words: Optional[int],
                 normalized: bool, device: torch.device, ranks: int = 1
                 ) -> Tuple[torch.Tensor, int, int]:
    """Normalize a phi statistic for serving on ``device``: float32, at
    least one guard row above the live vocabulary (appended when phi has
    none), beta-prior normalization over the live rows.  ``phi_acc`` may
    be a rank's [W, K/ranks] topic block: the normalization is per topic
    column, so a block needs nothing of the other ranks, and an
    already-normalized block's guard rows take 1/K of the global K.

    Returns ``(phi_norm [W', K], live, w_cap)``; the guard rows carry the
    prior mass an unseen word folds in.
    """
    phi = convert.phi_from_reference(phi_acc, live_words=live_words,
                                     device=device)
    w_cap = int(phi.shape[0])
    live = int(live_words) if live_words is not None else w_cap
    if live == w_cap:
        phi = torch.cat([phi, phi.new_zeros((1, phi.shape[1]))])
    if normalized:
        out = phi.clone()
        out[live:] = 1.0 / (phi.shape[1] * ranks)
        return out, live, w_cap
    return perplexity.normalize_phi(phi, cfg.beta, live_w=live), live, w_cap


class OOVTrigger:
    """Turn the engines' OOV measurement into retraining batches.

    Every admitted request reports its OOV keys; once ``min_docs``
    documents have gathered AND their OOV token rate reaches
    ``rate_threshold``, the hottest unseen keys are emitted as one
    admission batch of raw external-key documents, and the window resets.
    """

    def __init__(self, rate_threshold: float = 0.05, min_docs: int = 64,
                 batch_keys: int = 128):
        self.rate_threshold = float(rate_threshold)
        self.min_docs = int(min_docs)
        self.batch_keys = int(batch_keys)
        self._hot: Counter = Counter()
        self._docs = 0
        self._tokens = 0.0
        self._oov_tokens = 0.0
        self._batches: List[list] = []
        self.emitted = 0

    def observe(self, oov_keys, oov_counts, total_tokens: float) -> None:
        """One admitted request: its OOV (key, count) pairs and its token
        mass."""
        self._docs += 1
        self._tokens += float(total_tokens)
        for k, c in zip(oov_keys, oov_counts):
            self._hot[k] += float(c)
            self._oov_tokens += float(c)
        self._maybe_emit()

    def _maybe_emit(self) -> None:
        if self._docs < self.min_docs or self._tokens <= 0:
            return
        if self._oov_tokens / self._tokens < self.rate_threshold:
            return
        hot = self._hot.most_common(self.batch_keys)
        if not hot:
            return
        keys = np.asarray([k for k, _ in hot], np.int64)
        cnts = np.asarray([c for _, c in hot], np.float32)
        self._batches.append([(keys, cnts)])
        self.emitted += 1
        self._hot.clear()
        self._docs = 0
        self._tokens = 0.0
        self._oov_tokens = 0.0

    def take(self) -> List[list]:
        """Pop every pending admission batch."""
        out, self._batches = self._batches, []
        return out


@dataclasses.dataclass(frozen=True)
class _Placement:
    """Where an engine's phi lies: ``ranks`` topic blocks over ``group``
    (a mesh's ``model`` axis), this process's the ``rank``-th; one block
    and no group when phi is not split over ranks."""

    mesh: object = None
    placements: tuple = ()
    ranks: int = 1
    rank: int = 0
    group: object = None


def _rank_block(phi_acc, device: torch.device
                ) -> Tuple[object, _Placement]:
    """(this rank's block of phi, its `_Placement`).  A ``DTensor`` must
    keep its words whole and may split its topics (dim 1) evenly over the
    mesh's ``model`` axis only: any other placement, or a mesh on another
    device type than ``device``, raises ``ValueError``, since serving it
    would gather phi whole on a rank.  Anything else is one block."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(phi_acc, DTensor):
        return phi_acc, _Placement()
    mesh, places = phi_acc.device_mesh, tuple(phi_acc.placements)
    names = tuple(mesh.mesh_dim_names or ())
    if mesh.device_type != device.type:
        raise ValueError(f"phi is placed on a {mesh.device_type} mesh, the "
                         f"engine serves on {device}")
    ranks, rank = 1, 0
    for i, p in enumerate(places):
        if isinstance(p, Replicate) or mesh.size(i) == 1:
            continue                        # nothing split over this axis
        if not (isinstance(p, Shard) and p.dim == 1
                and i < len(names) and names[i] == "model"):
            raise ValueError(
                f"phi placed as {list(places)} on mesh axes {names}: "
                f"serving splits only its topics (dim 1) over the 'model' "
                f"axis and keeps its words whole; this placement would "
                f"gather phi whole on a rank")
        ranks, rank = mesh.size(i), mesh.get_coordinate()[i]
    if phi_acc.shape[1] % ranks:
        raise ValueError(f"phi's {phi_acc.shape[1]} topics do not split "
                         f"evenly over the {ranks} ranks of the 'model' "
                         f"axis")
    group = None
    if ranks > 1:
        import torch.distributed as dist

        group = mesh.get_group("model")
        if dist.get_rank(group) != rank:
            raise ValueError(
                f"this rank's model-axis coordinate {rank} is not its rank "
                f"{dist.get_rank(group)} in the model group: theta's blocks "
                f"would be gathered out of order")
    return phi_acc.to_local(), _Placement(mesh, places, ranks, rank, group)


class _Placed:
    """What both engines do with a placed phi: take its block, stack the
    rank's topic shards, agree host decisions across the model group and
    gather theta's blocks whole."""

    def _place_phi(self, phi_acc, cfg: LDAConfig, topic_shards: int,
                   live_words, normalized: bool) -> None:
        block, self._place = _rank_block(phi_acc, self.device)
        ranks = self._place.ranks
        if ranks > 1 and block.shape[1] * ranks != cfg.num_topics:
            raise ValueError(f"phi holds {block.shape[1] * ranks} topics, "
                             f"cfg.num_topics is {cfg.num_topics}")
        # N: one shard a rank for 1, else N/M stacked on each rank
        # (`split_topic_shards` refuses an N that M does not divide)
        self._topic_shards = (ranks if int(topic_shards) == 1
                              else int(topic_shards))
        self.theta_gather_bytes = 0
        self._install_phi(block, live_words, normalized)

    def _install_phi(self, block, live_words, normalized: bool) -> None:
        phi, self.live_words, self.w_cap = _prepare_phi(
            block, self.cfg, live_words, normalized, self.device,
            self._place.ranks)
        self._phi = infer.split_topic_shards(phi, self._topic_shards,
                                             self._place.ranks)
        self._oov_row = self.live_words

    def _swap_block(self, phi_acc):
        """The block of a swapped-in phi: a ``DTensor`` placed as the
        engine's phi, or a whole [W, K] statistic cut to this rank's
        columns on the host."""
        from torch.distributed.tensor import DTensor

        place = self._place
        if isinstance(phi_acc, DTensor):
            block, new = _rank_block(phi_acc, self.device)
            if (new.mesh, new.placements) != (place.mesh, place.placements):
                raise ValueError(
                    f"swap_phi: phi placed as {list(new.placements)} on "
                    f"another mesh or placement than the engine's "
                    f"{list(place.placements)}")
            return block
        if place.ranks == 1:
            return phi_acc
        whole = convert.phi_from_reference(phi_acc, device="cpu")
        width = whole.shape[1] // place.ranks
        return whole[:, place.rank * width:(place.rank + 1) * width]

    def _whole(self, theta: torch.Tensor) -> torch.Tensor:
        """theta's [D, K/M] blocks all-gathered over the model group, in
        rank order, into [D, K] (outside the byte meter, as the
        reference reads theta outside it)."""
        if self._place.group is None:
            return theta
        import torch.distributed as dist

        block = theta.contiguous()
        parts = [torch.empty_like(block) for _ in range(self._place.ranks)]
        dist.all_gather(parts, block, group=self._place.group)
        self.theta_gather_bytes += block.numel() * block.element_size()
        return torch.cat(parts, dim=-1)

    def _agree_max(self, values: Sequence[float]) -> List[float]:
        """Host values each rank measured for itself (clocks), maxed over
        the model group, so every rank takes the same decision from
        them."""
        if self._place.group is None:
            return list(values)
        import torch.distributed as dist

        t = torch.tensor(list(values), dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._place.group)
        return t.tolist()


def _load_serving_checkpoint(ckpt_dir: str, cfg: Optional[LDAConfig],
                             step: Optional[int], sharding, kw: dict):
    """Restore phi for serving (placed as a ``DTensor`` on the
    (``DeviceMesh``, spec) pair ``sharding`` when given), pick up a
    dynamic-vocabulary table, and (when ``cfg`` is omitted) build the
    config from phi's shape and the saved run signature."""
    from repro_torch.data.vocab import VocabMap
    from repro_torch.dist import checkpoint as ckpt

    phi_acc, extra, _ = ckpt.restore_phi(ckpt_dir, step=step,
                                         sharding=sharding,
                                         dtype=torch.float32)
    dyn = extra.get("dyn")
    if dyn is not None:
        kw.setdefault("live_words", int(dyn["live_w"]))
        kw.setdefault("phi_version", int(dyn.get("vocab_version", 0)))
        if dyn.get("vocab_keys") is not None:
            kw.setdefault("vocab", VocabMap(dyn["vocab_keys"]))
    if cfg is None:
        run = extra.get("run", {})
        if not run:
            warnings.warn(
                f"checkpoint in {ckpt_dir!r} carries no run signature; "
                f"serving with sync_dtype='float32' — pass cfg= if the "
                f"model was trained with other knobs", stacklevel=3)
        cfg = LDAConfig(vocab_size=int(phi_acc.shape[0]),
                        num_topics=int(phi_acc.shape[1]),
                        impl=str(run.get("impl", "jnp")),
                        sync_dtype=str(run.get("sync_dtype", "float32")))
    return phi_acc, cfg, kw


def _percentile(lats: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(lats, np.float64), q)) \
        if lats else float("nan")


@dataclasses.dataclass
class _Dispatch:
    bucket: int
    reqs: List[Tuple[int, float, float]]    # (req_id, t_submit, oov_tokens)
    theta: torch.Tensor                     # [D, K] on the device
    iters: int
    mean_r: torch.Tensor
    ready: Optional[torch.cuda.Event]       # None on the CPU
    phi_version: int = 0


class FoldInEngine(_Placed):
    """Serve topic mixtures with phi fixed, bucket-ladder admission.

    ``phi_acc`` is the trained statistic [W, K] (``normalized=True`` for an
    already-normalized matrix).  ``live_words`` marks rows [live_words, W)
    as guard rows; when absent one guard row is appended.  Word ids are
    translated through ``vocab`` (external keys, lookup only) when given,
    else range-checked; unknown words fold in through the first guard row
    and are counted in ``oov_rate``.

    Placed on a mesh (``phi_acc`` a ``DTensor``, see the module note), the
    engine holds this rank's [W', K/M] block; ``topic_shards`` = 1 serves
    one shard a rank, a multiple of M stacks N/M on each.  Every rank must
    submit the same requests in the same order: dispatch follows the
    queues, early exit the all-reduced residuals, and ``flush_stale`` the
    oldest request's age maxed over the ranks, so every rank dispatches
    the same batches.  Under gloo each all-reduce waits on the host.
    """

    def __init__(self, phi_acc, cfg: LDAConfig, *,
                 len_buckets: Sequence[int] = (16, 32, 64, 128),
                 batch_docs: int = 32, fold_iters: int = 30,
                 residual_tol: float = 1e-2, topic_shards: int = 1,
                 sync_dtype=None, normalized: bool = False,
                 seed: int = 0, warmup: bool = True, vocab=None,
                 live_words: Optional[int] = None,
                 phi_version: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.len_buckets = tuple(sorted(int(b) for b in len_buckets))
        if any(b % 8 for b in self.len_buckets):
            raise ValueError(f"len_buckets must be multiples of 8 "
                             f"(docs_to_padded pads L to 8): "
                             f"{self.len_buckets}")
        # the random init is drawn at the largest bucket and sliced, so a
        # document's theta does not depend on the bucket that admitted it
        self.cfg = cfg = dataclasses.replace(
            cfg, init_pad_len=max(self.len_buckets[-1],
                                  cfg.init_pad_len or 0))
        self.batch_docs = int(batch_docs)
        self.fold_iters = int(fold_iters)
        self.residual_tol = float(residual_tol)
        self.phi_version = int(phi_version)
        self._place_phi(phi_acc, cfg, topic_shards, live_words, normalized)
        self._vocab = vocab
        self._step, self.meter = infer.make_fold_in_step(
            cfg, fold_iters=self.fold_iters, residual_tol=self.residual_tol,
            topic_shards=self._topic_shards,
            sync_dtype=wire_dtype(sync_dtype or cfg.sync_dtype),
            device=self.device, model_group=self._place.group)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queues: Dict[int, List[Tuple[int, tuple, float, float]]] = {
            b: [] for b in self.len_buckets}
        self._pending: List[_Dispatch] = []
        self._next_id = 0
        self._dispatches = 0
        self._iters_sum = 0
        self._latencies: List[float] = []
        self._served = 0
        self._oov_tokens = 0.0
        self._total_tokens = 0.0
        self._t_first: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self.warmup_s = 0.0
        if warmup:
            self._warmup()

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg: Optional[LDAConfig] = None,
                        step: Optional[int] = None, sharding=None,
                        **kw) -> "FoldInEngine":
        """Checkpoint-to-serve: load phi (and, when ``cfg`` is omitted, the
        geometry from phi and the saved run signature) and build an engine
        on ``device`` (a keyword, default ``"cuda"``).  ``sharding``, a
        (``DeviceMesh``, spec) pair, places phi on the mesh first
        (`dist.checkpoint.restore_phi`): each rank reads only its block
        onto the device."""
        phi_acc, cfg, kw = _load_serving_checkpoint(ckpt_dir, cfg, step,
                                                    sharding, kw)
        return cls(phi_acc, cfg, **kw)

    def swap_phi(self, phi_acc, *, live_words: Optional[int] = None,
                 vocab=None, phi_version: Optional[int] = None) -> None:
        """Install a new (phi, vocab) generation.  Queued requests were
        admitted under the old vocabulary, so they are flushed and run on
        the old phi first and keep the old ``phi_version`` stamp.  A
        placed engine takes a ``DTensor`` placed as its phi, or a whole
        statistic of which it keeps its block."""
        self.flush()
        self._install_phi(self._swap_block(phi_acc), live_words, False)
        if vocab is not None:
            self._vocab = vocab
        self.phi_version = (int(phi_version) if phi_version is not None
                            else self.phi_version + 1)

    def _admit_doc(self, doc) -> Tuple[tuple, float]:
        """Translate a document into live phi rows; OOV words go to the
        first guard row, never an exception.  Returns ((rows, counts),
        oov token mass)."""
        ids, counts = doc
        counts = np.asarray(counts, np.float32)
        if self._vocab is not None:
            rows = self._vocab.rows(
                ids.tolist() if hasattr(ids, "tolist") else ids,
                admit=False, oov_row=self._oov_row)
        else:
            ids = np.asarray(ids)
            rows = np.where((ids >= 0) & (ids < self.live_words),
                            ids, self._oov_row).astype(np.int32)
        oov = float(counts[rows == self._oov_row].sum())
        self._oov_tokens += oov
        self._total_tokens += float(counts.sum())
        return (rows, counts), oov

    def submit(self, doc, req_id: Optional[int] = None) -> int:
        """Enqueue one document (word_ids, counts); returns the request id
        its `ServeResult` will carry."""
        if req_id is None:
            req_id = self._next_id
        self._next_id = max(self._next_id, req_id) + 1
        now = time.time()
        if self._t_first is None:
            self._t_first = now
        doc, oov = self._admit_doc(doc)
        b = bucket_len(len(doc[0]), self.len_buckets)
        q = self._queues[b]
        q.append((req_id, doc, now, oov))
        if len(q) >= self.batch_docs:
            self._dispatch(b)
        return req_id

    def flush(self) -> None:
        """Dispatch every partly filled bucket (padded with empty docs)."""
        for b in self.len_buckets:
            while self._queues[b]:
                self._dispatch(b)

    def flush_stale(self, max_age_s: float, now: Optional[float] = None
                    ) -> int:
        """Dispatch buckets whose oldest request has waited at least
        ``max_age_s``; returns the number of dispatches."""
        now = time.time() if now is None else now
        stale = self._agree_max([
            sum(now - t >= max_age_s for _, _, t, _ in self._queues[b])
            for b in self.len_buckets])
        n = 0
        for b, k in zip(self.len_buckets, stale):
            for _ in range(-(-int(k) // self.batch_docs)):
                self._dispatch(b)
                n += 1
        return n

    def _run(self, word_ids, counts):
        theta, iters, mean_r = self._step(
            self._phi, word_ids.to(self.device), counts.to(self.device),
            generator=self._gen)
        return self._whole(theta), iters, mean_r

    def _dispatch(self, bucket: int) -> None:
        q = self._queues[bucket]
        take, self._queues[bucket] = q[:self.batch_docs], q[self.batch_docs:]
        docs = [doc for _, doc, _, _ in take]
        docs += [_EMPTY_DOC] * (self.batch_docs - len(docs))
        mb = docs_to_padded(docs, max_len=bucket)
        theta, iters, mean_r = self._run(mb.word_ids, mb.counts)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._pending.append(_Dispatch(
            bucket=bucket, reqs=[(rid, t, oov) for rid, _, t, oov in take],
            theta=theta, iters=iters, mean_r=mean_r, ready=ready,
            phi_version=self.phi_version))
        self._dispatches += 1

    def _warmup(self) -> None:
        """Run every bucket shape once before any request arrives (on a
        card this also builds the kernel)."""
        t0 = time.time()
        for b in self.len_buckets:
            z = torch.zeros((self.batch_docs, b), dtype=torch.int32)
            self._run(z, z.float())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_s = time.time() - t0

    def _materialize(self, d: _Dispatch) -> List[ServeResult]:
        theta = d.theta.cpu().numpy()
        mean_r = float(d.mean_r)
        t_done = time.time()
        self._iters_sum += d.iters
        results = []
        for row, (rid, t_sub, oov) in enumerate(d.reqs):
            lat = t_done - t_sub
            self._latencies.append(lat)
            results.append(ServeResult(
                req_id=rid, theta=theta[row], latency_s=lat,
                bucket=d.bucket, iters=d.iters, mean_r=mean_r,
                oov_tokens=oov, phi_version=d.phi_version))
        self._t_last_done = t_done
        self._served += len(results)
        return results

    def drain(self) -> List[ServeResult]:
        """Flush partial buckets, then return every pending result in
        dispatch order."""
        self.flush()
        results: List[ServeResult] = []
        for d in self._pending:
            results.extend(self._materialize(d))
        self._pending.clear()
        return results

    def poll(self) -> List[ServeResult]:
        """Results of the dispatches whose device work has finished; never
        blocks, never flushes."""
        results: List[ServeResult] = []
        while self._pending:
            head = self._pending[0]
            if head.ready is not None and not head.ready.query():
                break
            results.extend(self._materialize(head))
            self._pending.pop(0)
        return results

    def in_flight(self) -> int:
        """Requests submitted but not yet returned (queued + dispatched)."""
        return (sum(len(q) for q in self._queues.values())
                + sum(len(d.reqs) for d in self._pending))

    def stats(self) -> Dict[str, object]:
        """Serving scorecard with the reference's keys.  ``compiles`` is 0:
        the port runs eagerly and compiles no step programs."""
        span = ((self._t_last_done - self._t_first)
                if self._latencies and self._t_first is not None else 0.0)
        mean_iters = (self._iters_sum / self._dispatches
                      if self._dispatches else 0.0)
        per_batch_bytes = self.meter.per_minibatch_bytes(max(mean_iters, 1))
        return {
            "served": self._served,
            "dispatches": self._dispatches,
            "docs_per_s": self._served / span if span > 0 else float("nan"),
            "latency_p50_s": _percentile(self._latencies, 50),
            "latency_p99_s": _percentile(self._latencies, 99),
            "mean_fold_iters": mean_iters,
            "compiles": 0,
            "len_buckets": list(self.len_buckets),
            "warmup_s": self.warmup_s,
            "bytes_by_phase": dict(self.meter.bytes_by_phase),
            "per_request_bytes": per_batch_bytes / max(self.batch_docs, 1),
            "live_words": self.live_words,
            "w_cap": self.w_cap,
            "occupancy": self.live_words / max(self.w_cap, 1),
            "phi_version": self.phi_version,
            "oov_rate": (self._oov_tokens / self._total_tokens
                         if self._total_tokens else 0.0),
        }


# ---------------------------------------------------------------------------
# continuous-batching slab engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SlabReq:
    """Host-side record of one admitted request (queued or in a slot)."""

    req_id: int
    t_submit: float
    oov: float
    tenant: Optional[Hashable] = None
    digest: Optional[str] = None
    warm: Optional[np.ndarray] = None    # cached theta for warm-start


@dataclasses.dataclass
class _StepOut:
    """One slab step's outputs on the host (pinned buffers on a card,
    filled asynchronously; ``ready`` completes when they are)."""

    retired: torch.Tensor              # [B] bool
    theta: torch.Tensor                # [B, K]
    iters: torch.Tensor                # [B] int32
    r_doc: torch.Tensor                # [B]
    phi_version: int
    ready: Optional[torch.cuda.Event]  # None on the CPU


class SlabEngine(_Placed):
    """Continuous-batching serving: one persistent in-flight slab.

    Per slot: **admit** (translate, queue) -> **iterate** (each step runs
    ``sweeps_per_step`` fold-in sweeps over every live slot) -> **retire**
    (the residual tail clears ``residual_tol`` or ``fold_iters`` is hit) ->
    **refill** (the freed slot takes the next queued request).  Documents
    longer than ``slot_len`` are truncated by top count mass.

      - ``theta_cache`` (an int capacity or a `ThetaCache`): repeat
        (tenant, content) documents skip fold-in (``cache_mode='serve'``)
        or warm-start from the cached theta (``'warm'``); entries are
        stamped with the phi version, so a swap invalidates them;
      - ``oov_trigger``: an `OOVTrigger` fed by admission;
      - ``admission_slo_s``: a request whose estimated wait exceeds it is
        refused with a `Shed`; non-finite input is quarantined.

    ``swap_phi`` pumps the slab to empty first, so every admitted request
    retires under the (phi, version) that admitted it.

    Placed on a mesh (``phi_acc`` a ``DTensor``, see the module note), the
    engine holds this rank's [W', K/M] block and its slab state's K/M
    columns; ``topic_shards`` as in `FoldInEngine`.  Every rank must submit
    the same requests in the same order, and every rank then decides the
    same: freezing, retiring and the residual tail come from all-reduced
    values; a step is harvested only when ``pipeline`` steps are in
    flight, never when its event happens to have completed; and with
    ``admission_slo_s`` each step's wall time is maxed over the ranks (a
    host sync a step) before shedding reads it.  Under NCCL the step
    still never waits for the card; under gloo each all-reduce waits on
    the host.
    """

    def __init__(self, phi_acc, cfg: LDAConfig, *, slots: int = 64,
                 slot_len: int = 64, sweeps_per_step: int = 4,
                 refill_cap: Optional[int] = None, fold_iters: int = 30,
                 residual_tol: float = 1e-2, topic_shards: int = 1,
                 sync_dtype=None, normalized: bool = False,
                 seed: int = 0, warmup: bool = True, vocab=None,
                 live_words: Optional[int] = None, phi_version: int = 0,
                 theta_cache=None, cache_mode: str = "serve",
                 oov_trigger: Optional[OOVTrigger] = None,
                 pipeline: int = 4,
                 admission_slo_s: Optional[float] = None, device="cuda"):
        if cache_mode not in ("serve", "warm"):
            raise ValueError(f"cache_mode must be 'serve' or 'warm': "
                             f"{cache_mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = int(slots)
        self.slot_len = int(slot_len)
        self.sweeps_per_step = int(sweeps_per_step)
        # refill lanes default to slots/4: the refill work runs every step
        # that admits, so full-width lanes tax steady state for cold start
        self._refill_cap = (max(1, self.slots // 4) if refill_cap is None
                            else int(refill_cap))
        self.fold_iters = int(fold_iters)
        self.residual_tol = float(residual_tol)
        self.phi_version = int(phi_version)
        self._K = int(cfg.num_topics)
        self.cache = (ThetaCache(theta_cache)
                      if isinstance(theta_cache, int) else theta_cache)
        self.cache_mode = cache_mode
        self.trigger = oov_trigger
        self._place_phi(phi_acc, cfg, topic_shards, live_words, normalized)
        self._vocab = vocab
        self._init_state, self._step, self.meter = infer.make_slab_step(
            cfg, slots=self.slots, slot_len=self.slot_len,
            refill_cap=self._refill_cap,
            sweeps_per_step=self.sweeps_per_step,
            fold_iters=self.fold_iters, residual_tol=self.residual_tol,
            topic_shards=self._topic_shards,
            sync_dtype=wire_dtype(sync_dtype or cfg.sync_dtype),
            device=self.device, model_group=self._place.group)
        self._state = self._init_state()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: "deque[Tuple[_SlabReq, np.ndarray, np.ndarray]]" = \
            deque()
        self._slot_req: List[Optional[_SlabReq]] = [None] * self.slots
        self._free: "deque[int]" = deque(range(self.slots))
        self._done: List[ServeResult] = []
        # steps in flight, harvested lazily: a deeper window pipelines
        # better but delays retire -> refill by up to that many steps
        self._pipeline = max(0, int(pipeline))
        self._pending: "deque[_StepOut]" = deque()
        self._next_id = 0
        self._steps = 0
        self._occ_sum = 0
        self._served = 0
        self._cache_served = 0
        self._warm_served = 0
        self._cold_served = 0
        self._iters_sum = 0
        self._warm_iters = 0
        self._cold_iters = 0
        self._billed_bytes = 0.0
        self._rates: Optional[Tuple[float, float]] = None
        self._latencies: List[float] = []
        self._oov_tokens = 0.0
        self._total_tokens = 0.0
        self._t_first: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self.admission_slo_s = (float(admission_slo_s)
                                if admission_slo_s is not None else None)
        self._shed_count = 0
        self._quarantined = 0
        self._step_ema_s: Optional[float] = None
        self.warmup_s = 0.0
        if warmup:
            self._warmup()

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg: Optional[LDAConfig] = None,
                        step: Optional[int] = None, sharding=None,
                        **kw) -> "SlabEngine":
        """Checkpoint-to-serve for the slab (same contract as
        `FoldInEngine.from_checkpoint`)."""
        phi_acc, cfg, kw = _load_serving_checkpoint(ckpt_dir, cfg, step,
                                                    sharding, kw)
        return cls(phi_acc, cfg, **kw)

    # ---------------------------------------------------------- admission

    def _admit_doc(self, doc) -> Tuple[np.ndarray, np.ndarray, float]:
        """Translate external ids to live phi rows (OOV -> guard row) and
        feed the OOV trigger."""
        ids, counts = doc
        ids = np.asarray(ids)
        counts = np.asarray(counts, np.float32)
        if self._vocab is not None:
            rows = np.asarray(self._vocab.rows(ids.tolist(), admit=False,
                                               oov_row=self._oov_row),
                              np.int32)
        else:
            rows = np.where((ids >= 0) & (ids < self.live_words),
                            ids, self._oov_row).astype(np.int32)
        oov_mask = rows == self._oov_row
        oov = float(counts[oov_mask].sum())
        self._oov_tokens += oov
        self._total_tokens += float(counts.sum())
        if self.trigger is not None:
            self.trigger.observe(ids[oov_mask].tolist(), counts[oov_mask],
                                 float(counts.sum()))
        return rows, counts, oov

    def _finish_now(self, req_id, t_submit, theta, *, oov=0.0,
                    cached=False, tenant=None, error=None) -> None:
        """Record a request that completes at submit (cache hit or
        quarantine)."""
        t_done = time.time()
        lat = t_done - t_submit
        self._done.append(ServeResult(
            req_id=req_id, theta=theta, latency_s=lat, bucket=-1, iters=0,
            mean_r=0.0, oov_tokens=oov, phi_version=self.phi_version,
            comm_bytes=0.0, cached=cached, tenant=tenant, error=error))
        self._latencies.append(lat)
        self._served += 1
        self._t_last_done = t_done

    def submit(self, doc, req_id: Optional[int] = None,
               tenant: Optional[Hashable] = None) -> "int | Shed":
        """Admit one document; never waits for the device.  A cache hit in
        ``serve`` mode completes at once; a document with non-finite counts
        retires at once with ``error='nonfinite_input'``; with
        ``admission_slo_s`` set, a request whose estimated wait exceeds it
        is refused with a `Shed`."""
        if req_id is None:
            req_id = self._next_id
        self._next_id = max(self._next_id, req_id) + 1
        now = time.time()
        if self._t_first is None:
            self._t_first = now
        if not np.isfinite(np.asarray(doc[1], np.float32)).all():
            self._quarantined += 1
            self._finish_now(req_id, now,
                             np.full((self._K,), 1.0 / self._K, np.float32),
                             tenant=tenant, error="nonfinite_input")
            return req_id
        # the digest hashes the raw payload, before vocabulary translation
        digest = (doc_digest(doc[0], doc[1])
                  if self.cache is not None else None)
        rows, counts, oov = self._admit_doc(doc)
        req = _SlabReq(req_id=req_id, t_submit=now, oov=oov,
                       tenant=tenant, digest=digest)
        if self.cache is not None:
            hit = self.cache.get(tenant, digest, self.phi_version)
            if hit is not None:
                if self.cache_mode == "serve":
                    self._finish_now(req_id, now, np.asarray(hit), oov=oov,
                                     cached=True, tenant=tenant)
                    self._cache_served += 1
                    return req_id
                req.warm = np.asarray(hit, np.float32)
        if self.admission_slo_s is not None:
            est = self._est_wait_s()
            if est > self.admission_slo_s:
                self._shed_count += 1
                return Shed(req_id=req_id, est_wait_s=est,
                            slo_s=self.admission_slo_s,
                            queue_depth=len(self._queue), tenant=tenant)
        self._queue.append((req, rows, counts))
        return req_id

    def _est_wait_s(self) -> float:
        """Wait estimate for a request queued now: queue-ahead dispatch
        delay plus one slot tenure, at the measured step time.  A cold
        engine (no step yet) estimates 0 and always admits."""
        if self._step_ema_s is None:
            return 0.0
        tenure = max(1.0, self.fold_iters / self.sweeps_per_step)
        rate = max(1e-9, min(float(self._refill_cap), self.slots / tenure))
        return self._step_ema_s * (len(self._queue) / rate + tenure)

    # ------------------------------------------------------------ iterate

    def live_slots(self) -> int:
        return self.slots - len(self._free)

    def in_flight(self) -> int:
        """Requests admitted but not yet retired (queued + in a slot)."""
        return len(self._queue) + self.live_slots()

    def _stage(self, retired, theta_out, iters, r_doc) -> _StepOut:
        """Start copying one step's outputs to the host without waiting."""
        if self.device.type != "cuda":
            return _StepOut(retired, theta_out, iters, r_doc,
                            self.phi_version, None)
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in (retired, theta_out, iters, r_doc)]
        for h, x in zip(host, (retired, theta_out, iters, r_doc)):
            h.copy_(x, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return _StepOut(*host, self.phi_version, ready)

    def step(self) -> int:
        """One slab step: refill free slots from the queue, advance the
        slab, and harvest whatever earlier steps have finished.  Waits for
        the device only when ``pipeline`` steps are already in flight.
        Returns how many documents were harvested."""
        t0 = time.time()
        n_take = min(len(self._queue), len(self._free), self._refill_cap)
        take = [self._queue.popleft() for _ in range(n_take)]
        slot_ids = [self._free.popleft() for _ in range(n_take)]
        wid, cnt, slot, _ = slab_refill(
            [(rows, counts) for _, rows, counts in take], slot_ids,
            capacity=self._refill_cap, slot_len=self.slot_len,
            pad_slot=self.slots)
        warm = np.zeros((self._refill_cap, self._K), np.float32)
        wmask = np.zeros((self._refill_cap,), bool)
        for i, (req, _, _) in enumerate(take):
            if req.warm is not None:
                warm[i] = req.warm
                wmask[i] = True
        for s, (req, _, _) in zip(slot_ids, take):
            self._slot_req[s] = req
        self._occ_sum += self.live_slots()
        self._state, retired, theta_out, iters, r_doc = self._step(
            self._phi, self._state, wid, cnt, slot, warm, wmask,
            generator=self._gen)
        self._steps += 1
        self._pending.append(self._stage(retired, self._whole(theta_out),
                                         iters, r_doc))
        n = self._harvest(block=len(self._pending) > self._pipeline)
        dt = time.time() - t0
        if self.admission_slo_s is not None:
            dt, = self._agree_max([dt])
        self._step_ema_s = (dt if self._step_ema_s is None
                            else 0.8 * self._step_ema_s + 0.2 * dt)
        return n

    def _harvest(self, block: bool = False) -> int:
        """Materialize finished steps off the head of the pipeline;
        ``block`` waits for the oldest one first."""
        n = 0
        while self._pending:
            head = self._pending[0]
            if head.ready is not None:
                if block:
                    head.ready.synchronize()
                elif self._place.group is not None or not head.ready.query():
                    break       # placed: the ranks harvest at the same steps
            self._pending.popleft()
            n += self._materialize(head)
            block = False
        return n

    def _materialize(self, out: _StepOut) -> int:
        ret = out.retired.numpy()
        if not ret.any():
            return 0
        th = out.theta.numpy()
        itn = out.iters.numpy()
        rn = out.r_doc.numpy()
        t_done = time.time()
        sweep_b, once_b = self._billing_rates()
        n = 0
        for s in np.nonzero(ret)[0]:
            s = int(s)
            req = self._slot_req[s]
            if req is None:     # retired in an older pipelined step and
                continue        # already harvested from it
            self._slot_req[s] = None
            self._free.append(s)
            doc_iters = int(itn[s])
            bytes_d = sweep_b * doc_iters + once_b
            lat = t_done - req.t_submit
            theta_d = th[s].copy()
            finite = bool(np.isfinite(theta_d).all())
            if not finite:
                self._quarantined += 1
            if (self.cache is not None and req.digest is not None
                    and finite):
                self.cache.put(req.tenant, req.digest, out.phi_version,
                               theta_d)
            self._done.append(ServeResult(
                req_id=req.req_id, theta=theta_d, latency_s=lat,
                bucket=s, iters=doc_iters, mean_r=float(rn[s]),
                oov_tokens=req.oov, phi_version=out.phi_version,
                comm_bytes=bytes_d, cached=False, tenant=req.tenant,
                error=None if finite else "nonfinite_theta"))
            self._latencies.append(lat)
            self._iters_sum += doc_iters
            if req.warm is not None:
                self._warm_iters += doc_iters
                self._warm_served += 1
            else:
                self._cold_iters += doc_iters
                self._cold_served += 1
            self._billed_bytes += bytes_d
            self._served += 1
            n += 1
        self._t_last_done = t_done
        return n

    def pump(self, max_steps: Optional[int] = None) -> int:
        """Step until the queue, slab and pipeline are all empty (or
        ``max_steps``); ``fold_iters`` bounds every slot's tenure, so this
        ends.  Returns the number of steps run."""
        steps = 0
        while max_steps is None or steps < max_steps:
            if self._queue or self.live_slots():
                self.step()
                steps += 1
            elif self._pending:
                self._harvest(block=True)
            else:
                break
        return steps

    def poll(self) -> List[ServeResult]:
        """Pop every result harvested so far; never blocks, never steps."""
        out, self._done = self._done, []
        return out

    def drain(self) -> List[ServeResult]:
        """Pump the slab to empty and return every outstanding result."""
        self.pump()
        return self.poll()

    def swap_phi(self, phi_acc, *, live_words: Optional[int] = None,
                 vocab=None, phi_version: Optional[int] = None) -> None:
        """Install a new (phi, vocab) generation after pumping the slab to
        empty, so no request observes a torn phi.  A placed engine takes
        what `FoldInEngine.swap_phi` takes."""
        self.pump()
        self._install_phi(self._swap_block(phi_acc), live_words, False)
        if vocab is not None:
            self._vocab = vocab
        self.phi_version = (int(phi_version) if phi_version is not None
                            else self.phi_version + 1)

    def take_retrain_batches(self) -> List[list]:
        """Pop pending hot-OOV admission batches from the trigger."""
        return self.trigger.take() if self.trigger is not None else []

    # -------------------------------------------------------------- stats

    def _warmup(self) -> None:
        """Advance the empty slab once before any request arrives (on a card
        this also builds the kernel): semantically a no-op."""
        t0 = time.time()
        R = self._refill_cap
        self._state, *_ = self._step(
            self._phi, self._state,
            np.zeros((R, self.slot_len), np.int32),
            np.zeros((R, self.slot_len), np.float32),
            np.full((R,), self.slots, np.int32),
            np.zeros((R, self._K), np.float32),
            np.zeros((R,), bool), generator=self._gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_s = time.time() - t0

    def _billing_rates(self) -> Tuple[float, float]:
        """(bytes a slot-sweep, bytes a document) from the metered step, as
        the reference attributes them: the loop phases split evenly over
        the step's sweeps and slots, so a document pays for its own
        sweeps, plus its share of the once-a-document phases (the init
        over the refill lanes, theta's normalizer over the slots).  Zero
        when phi is unsharded (the local reducer meters nothing)."""
        if self._rates is None:
            by = self.meter.bytes_by_phase
            loop = (by.get("slab_norm_loop", 0.0)
                    + by.get("slab_rw_loop", 0.0))
            once = (by.get("slab_init_norm", 0.0) / max(self._refill_cap, 1)
                    + by.get("slab_theta_norm", 0.0) / self.slots)
            self._rates = (loop / self.sweeps_per_step / self.slots, once)
        return self._rates

    def stats(self) -> Dict[str, object]:
        """Serving scorecard with the reference's keys.  ``compiles`` is 0:
        the port runs eagerly and compiles no step programs."""
        span = ((self._t_last_done - self._t_first)
                if self._latencies and self._t_first is not None else 0.0)
        folded = self._cold_served + self._warm_served
        out: Dict[str, object] = {
            "served": self._served,
            "steps": self._steps,
            "docs_per_s": self._served / span if span > 0 else float("nan"),
            "latency_p50_s": _percentile(self._latencies, 50),
            "latency_p99_s": _percentile(self._latencies, 99),
            "mean_fold_iters": (self._iters_sum / folded if folded
                                else 0.0),
            "cold_fold_iters": (self._cold_iters / self._cold_served
                                if self._cold_served else 0.0),
            "warm_fold_iters": (self._warm_iters / self._warm_served
                                if self._warm_served else 0.0),
            "compiles": 0,
            "slots": self.slots,
            "slot_len": self.slot_len,
            "sweeps_per_step": self.sweeps_per_step,
            "slot_occupancy": (self._occ_sum / self._steps / self.slots
                               if self._steps else 0.0),
            "warmup_s": self.warmup_s,
            "bytes_by_phase": dict(self.meter.bytes_by_phase),
            "per_request_bytes": (self._billed_bytes / folded if folded
                                  else 0.0),
            "live_words": self.live_words,
            "w_cap": self.w_cap,
            "occupancy": self.live_words / max(self.w_cap, 1),
            "phi_version": self.phi_version,
            "oov_rate": (self._oov_tokens / self._total_tokens
                         if self._total_tokens else 0.0),
            "cache_served": self._cache_served,
            "warm_starts": self._warm_served,
            "retrain_batches": (self.trigger.emitted if self.trigger
                                else 0),
            "shed": self._shed_count,
            "shed_frac": (self._shed_count
                          / max(1, self._shed_count + self._served
                                + self.in_flight())),
            "quarantined": self._quarantined,
            "admission_slo_s": self.admission_slo_s,
            "step_ema_s": (self._step_ema_s if self._step_ema_s is not None
                           else 0.0),
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out
