"""External-key vocabulary lookup for serving (the lookup half of
``repro.data.vocab.VocabMap``; admission, touch stamps and compaction come
with the dynamic-vocabulary slice)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class VocabMap:
    """External-token -> dense-row map, rebuilt from a checkpoint's key list
    (row i -> keys[i])."""

    def __init__(self, keys: Iterable = ()):
        self._keys: List = list(keys)
        self._rows: Dict = {k: i for i, k in enumerate(self._keys)}
        if len(self._rows) != len(self._keys):
            raise ValueError("VocabMap keys must be unique")

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def live(self) -> int:
        """Current live vocabulary size (== the next row to be assigned)."""
        return len(self._keys)

    def lookup(self, key) -> Optional[int]:
        return self._rows.get(key)

    def rows(self, keys: Sequence, oov_row: int) -> np.ndarray:
        """Key -> row translation; unseen keys map to ``oov_row`` (serving
        never moves the vocabulary)."""
        get = self._rows.get
        return np.asarray([get(k, oov_row) for k in keys], np.int32)

    def to_state(self) -> List:
        """JSON-able payload for the checkpoint manifest."""
        return list(self._keys)

    @classmethod
    def from_state(cls, keys: Iterable) -> "VocabMap":
        return cls(keys)
