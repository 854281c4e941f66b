"""Per-tenant theta LRU cache for repeat documents (a copy of
``repro.serve.cache``).

Serving workloads are heavy-tailed in *content*: the same document (a hot
article, a template, a retried request) arrives again and again, often from
the same tenant.  Fixed-phi fold-in is a pure function of
(document, phi generation), so its result is perfectly cacheable:

  - keys are ``(tenant, content digest)`` where the digest hashes the raw
    (word_ids, counts) payload BEFORE vocab translation — two requests
    with identical content collide whatever rows the current vocabulary
    maps them to;
  - every entry is stamped with the ``phi_version`` that produced it; a
    lookup under any other version MISSES (and evicts the stale entry), so
    a phi hot-swap invalidates the whole cache at zero cost — no stale
    theta is ever served across a model refresh;
  - eviction is LRU over a bounded entry count, shared across tenants
    (a tenant's working set competes like any other — per-tenant quotas
    would go here).

Two consumption modes (the engine's ``cache_mode``):
  ``serve``: a hit skips fold-in entirely — the cached theta is returned
             with zero device work and ~zero latency;
  ``warm``:  a hit still folds in, but the slot's messages initialize from
             the cached theta instead of the random field, so the residual
             bound clears in fewer sweeps (measured in ``stats()``).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Hashable, Optional, Tuple

import numpy as np

Key = Tuple[Hashable, str]


def doc_digest(ids, counts) -> str:
    """Content hash of one (word_ids, counts) document payload."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(np.asarray(ids, np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(counts, np.float32)).tobytes())
    return h.hexdigest()


class ThetaCache:
    """Bounded LRU of ``(tenant, digest) -> (phi_version, theta)``."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._d: "OrderedDict[Key, Tuple[int, np.ndarray]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.stale = 0          # lookups that found an older-phi entry

    def __len__(self) -> int:
        return len(self._d)

    def get(self, tenant: Hashable, digest: str, phi_version: int
            ) -> Optional[np.ndarray]:
        """The cached theta for this content under THIS phi generation,
        or None.  A version mismatch is a miss and evicts the dead entry
        (it can never hit again — versions only move forward)."""
        key = (tenant, digest)
        ent = self._d.get(key)
        if ent is None:
            self.misses += 1
            return None
        ver, theta = ent
        if ver != phi_version:
            del self._d[key]
            self.stale += 1
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return theta

    def put(self, tenant: Hashable, digest: str, phi_version: int,
            theta: np.ndarray) -> None:
        key = (tenant, digest)
        self._d[key] = (int(phi_version), np.asarray(theta))
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def purge(self) -> None:
        """Drop every entry (an explicit swap-time invalidation; version
        stamping already guarantees stale entries never serve, purging
        just reclaims the memory eagerly)."""
        self._d.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "stale_evictions": self.stale,
                "hit_rate": self.hits / total if total else 0.0}
