"""Seeds of a run's parts, derived from ``--seed``: the same seed gives the
same inputs, and each part draws from a stream of its own."""

from __future__ import annotations

import hashlib


def derive(seed: int, tag: str) -> int:
    """A 62-bit seed for part ``tag`` of the run seeded ``seed`` (any
    whole number)."""
    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2
