"""Dynamic vocabulary: the token -> row map and the W capacity ladder, a
copy of ``repro.data.vocab`` (numpy only, so both packages build the same
maps from the same stream).

  - ``VocabMap`` gives each external token key its phi row in first-seen
    order (append-only between compaction fences), so two runs that consume
    the same batches build the same map; it stamps each row with the last
    batch that touched it (max-merge, so a replayed batch changes nothing)
    and round-trips through a checkpoint manifest as its key list and
    stamps.  ``compact`` (at a checkpoint fence) reclaims dead rows and
    slides the survivors down to a dense prefix, returning the row remap.
  - ``next_capacity`` is the geometric rung ladder: phi_acc is allocated at
    a rung, rows in [live_w, W_cap) are guard rows (zero statistics, never
    selected, outside the W*beta smoothing), and the rung is always
    strictly above the live vocabulary, so a guard row always exists (the
    dead slots of the power selection and serving's OOV row point at the
    first one).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.data.synthetic import Doc


def next_capacity(live_w: int, current_cap: int = 0, min_cap: int = 64,
                  growth: float = 2.0, multiple: int = 8) -> int:
    """The smallest ladder rung strictly greater than ``live_w``.

    Rungs start at ``min_cap`` (rounded up to ``multiple``) and grow
    geometrically by ``growth``; ``current_cap`` (a rung already on the
    ladder) is the starting point, so repeated calls walk the same rungs.
    """
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    cap = max(1, -(-int(min_cap) // multiple) * multiple)
    cap = max(cap, int(current_cap))
    while cap <= live_w:
        cap = max(cap + multiple,
                  -(-int(round(cap * growth)) // multiple) * multiple)
    return cap


class VocabMap:
    """External-token -> dense-row map, append-only between compaction
    fences.

    Keys may be any hashable JSON-able value.  Admission order is the row
    order, so the first ``n`` keys are the vocabulary as of the admission
    that made its live size ``n`` (`keys_upto`): a checkpoint can save that
    prefix while a prefetch thread admits ahead.  ``compact`` is the one
    exception to append-only: dead rows are reclaimed and the survivors
    slide down, as the returned remap says.
    """

    def __init__(self, keys: Iterable = (), touched: Optional[Iterable] = ()):
        self._keys: List = list(keys)
        self._rows: Dict = {k: i for i, k in enumerate(self._keys)}
        if len(self._rows) != len(self._keys):
            raise ValueError("VocabMap keys must be unique")
        # last-touched batch per row (-1: never touched with a step); max-
        # merged, so replaying a consumed prefix leaves the stamps as they
        # were
        t = list(touched) if touched else []
        if len(t) > len(self._keys):
            raise ValueError(f"touched covers {len(t)} rows but only "
                             f"{len(self._keys)} keys exist")
        self._touched: List[int] = t + [-1] * (len(self._keys) - len(t))

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def live(self) -> int:
        """Current live vocabulary size (== the next row to be assigned)."""
        return len(self._keys)

    def lookup(self, key) -> Optional[int]:
        return self._rows.get(key)

    def admit(self, key, step: Optional[int] = None) -> int:
        """Row of ``key``, appended if unseen; ``step`` stamps the row as
        touched at that batch (never moving a stamp back)."""
        row = self._rows.get(key)
        if row is None:
            row = len(self._keys)
            self._rows[key] = row
            self._keys.append(key)
            self._touched.append(-1)
        if step is not None and self._touched[row] < step:
            self._touched[row] = step
        return row

    def rows(self, keys: Sequence, admit: bool = True,
             oov_row: Optional[int] = None,
             step: Optional[int] = None) -> np.ndarray:
        """Key -> row translation, int32.

        ``admit=True`` (the default, as in the reference) appends unseen
        keys: training admission.  ``admit=False`` maps them to ``oov_row``
        instead: serving and evaluation, where a lookup must not move the
        vocabulary.  ``step`` stamps every admitted row as touched.
        """
        if admit:
            return np.asarray([self.admit(k, step=step) for k in keys],
                              np.int32)
        if oov_row is None:
            raise ValueError("admit=False needs an oov_row")
        get = self._rows.get
        return np.asarray([get(k, oov_row) for k in keys], np.int32)

    def map_docs(self, docs: Sequence[Doc], admit: bool = True,
                 oov_row: Optional[int] = None,
                 step: Optional[int] = None) -> List[Doc]:
        """``(word_keys, counts)`` documents translated to row space."""
        return [(self.rows(ids.tolist() if hasattr(ids, "tolist") else ids,
                           admit=admit, oov_row=oov_row, step=step), counts)
                for ids, counts in docs]

    def keys_upto(self, n: int) -> List:
        """The first ``n`` keys: the vocabulary as of the admission that
        made the live size ``n`` (a prefix of an append-only list, so safe
        beside a thread that appends)."""
        return list(self._keys[:n])

    def touched_upto(self, n: int) -> List[int]:
        """Last-touched batch of the first ``n`` rows (the manifest's
        payload beside `keys_upto`)."""
        return list(self._touched[:n])

    def compact(self, keep: Sequence[bool]) -> np.ndarray:
        """Drop dead rows; the survivors slide down to a dense prefix in
        their order.

        ``keep`` masks the first ``len(keep)`` rows (rows past it are
        kept).  Returns the int32 remap over the rows before compaction:
        ``remap[i]`` is row i's new row, -1 where reclaimed, a function of
        the mask alone.  The freed rows become guard rows: the next
        admissions take them before the ladder grows.
        """
        keep = np.asarray(list(keep) + [True] * (len(self._keys) - len(keep)),
                          bool)
        remap = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
        self._keys = [k for k, b in zip(self._keys, keep) if b]
        self._touched = [t for t, b in zip(self._touched, keep) if b]
        self._rows = {k: i for i, k in enumerate(self._keys)}
        return remap

    def to_state(self) -> List:
        """JSON-able payload for the checkpoint manifest."""
        return list(self._keys)

    @classmethod
    def from_state(cls, keys: Iterable,
                   touched: Optional[Iterable] = ()) -> "VocabMap":
        return cls(keys, touched=touched)
