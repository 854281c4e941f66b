"""The port's span and counter record: what the host does inside a training
step (POBP's, root ``pobp.step``; the LM trainer's, root ``lm.step``),
kept while a torch profiler records in this process.

A step is recorded if and only if a profiler was recording when its root
span (`step`, opened by ``core.pobp.make_train_step`` and by
``launch.train.build_trainer``'s step) opened, and it is kept whole.  A
span holds its name, its start and end on ``time.time_ns()`` (the clock
of the profiler's events: a ``record_function`` range starts at
``prof.profiler.kineto_results.trace_start_ns()`` plus its
``time_range.start`` in microseconds), the index of its parent span in the
step (-1 for the root), the step's id and the shard that ran it.  A step's
counters are host ints set by the code that ran it, and device scalars
(`Recorder.tally`, summed; `Recorder.peak`, their largest) over its shards
and calls, read back once, when the step closes.

The record keeps the last `RING` steps and holds no tensor.  A recorded
step that opens after a step that opened with the profiler off empties the
record first, so it holds the steps of the latest stretch of recording: the
traced slice of a benchmark run, whatever ran before it in the process.
`steps` returns them; `clear` empties the record.

With the profiler off a step costs its root one flag check, and every span
site inside it one ``is None`` check: no device operation, no host read, no
allocation.  A `span` is not a ``record_function`` range, so nothing of
it reaches the profiler's device timeline; a `region` (the LM model's
spans) is both, so the trace gives the device time of the operations it
encloses.  The LM forward runs again in the backward pass under
activation checkpointing, on autograd's thread: `replay` carries the
step's record there, its spans recorded and its counters not (they count
the forward once).  While recording, a span adds numbers to flat arrays
and no object that outlives it: surviving objects
set off the garbage collector, whose passes took ~0.3 s each under the
profiler on an H100 machine, PERF.md §6 (`Span` objects are made only by
`steps`).
"""

from __future__ import annotations

import array
import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

RING = 64


def recording() -> bool:
    """Whether a torch profiler records in this process: the flag that
    ``torch.profiler.profile`` sets on entry and clears on exit."""
    return _profiler._is_profiler_enabled


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int            # index in the step's spans; -1 for the root
    step: int
    shard: int


@dataclasses.dataclass
class Step:
    id: int
    spans: List[Span]
    counters: Dict[str, int]


class _Kept:
    """One recorded step as it is kept: per span its name, and four ints
    (start, end, parent, shard) in one flat array."""

    def __init__(self, step_id: int):
        self.id = step_id
        self.names: List[str] = []
        self.rows = array.array("q")
        self.counters: Dict[str, int] = {}
        # (name, 'sum' | 'max') -> the device scalars added
        self.tallies: Dict[Tuple[str, str], List[torch.Tensor]] = {}
        self.lock = threading.Lock()

    def step(self) -> Step:
        r = self.rows
        return Step(self.id, [Span(n, r[4 * i], r[4 * i + 1], r[4 * i + 2],
                                   self.id, r[4 * i + 3])
                              for i, n in enumerate(self.names)],
                    dict(self.counters))


class Recorder:
    """One thread's handle on an open recorded step: the shard it runs and
    its stack of open spans."""

    __slots__ = ("_kept", "shard", "_stack", "_counts")

    def __init__(self, kept: _Kept, shard: int, stack: List[int],
                 counts: bool = True):
        self._kept = kept
        self.shard = shard
        self._stack = stack
        self._counts = counts

    def _begin(self, name: str) -> int:
        k = self._kept
        parent = self._stack[-1] if self._stack else -1
        with k.lock:
            i = len(k.names)
            k.names.append(name)
            k.rows.extend((time.time_ns(), 0, parent, self.shard))
        self._stack.append(i)
        return i

    def _end(self, i: int) -> None:
        self._kept.rows[4 * i + 1] = time.time_ns()
        self._stack.pop()

    def count(self, **values: int) -> None:
        """Set host counters of the step (the same from every shard)."""
        if not self._counts:
            return
        with self._kept.lock:
            self._kept.counters.update(
                {k: int(v) for k, v in values.items()})

    def tally(self, **values: torch.Tensor) -> None:
        """Add device scalars to the step's counters, summed over the
        shards and calls and read back once when the step closes."""
        self._add("sum", values)

    def peak(self, **values: torch.Tensor) -> None:
        """Device scalars whose largest over the shards and calls is the
        step's counter, read back once when the step closes."""
        self._add("max", values)

    def _add(self, how: str, values: Dict[str, torch.Tensor]) -> None:
        if not self._counts:
            return
        with self._kept.lock:
            for k, v in values.items():
                self._kept.tallies.setdefault((k, how), []).append(v)


class _SpanCtx:
    __slots__ = ("_rec", "_name", "_i")

    def __init__(self, rec: Recorder, name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._i = self._rec._begin(self._name)
        return self

    def __exit__(self, *exc):
        self._rec._end(self._i)
        return False


_OFF = contextlib.nullcontext()


class _Record:
    """The process's ring of recorded steps."""

    def __init__(self):
        self.ring: collections.deque = collections.deque(maxlen=RING)
        self.next_id = 0
        self.stretch_open = False
        self.lock = threading.Lock()


_RECORD = _Record()
_local = threading.local()


def active() -> Optional[Recorder]:
    """This thread's recorder of the step it runs, or None when that step
    is not recorded."""
    return getattr(_local, "rec", None)


def span(rec: Optional[Recorder], name: str):
    """A span named ``name`` under ``rec``'s open span; nothing when
    ``rec`` is None."""
    return _OFF if rec is None else _SpanCtx(rec, name)


class _RegionCtx(_SpanCtx):
    __slots__ = ("_range",)

    def __enter__(self):
        self._range = _profiler.record_function(self._name)
        self._range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._range.__exit__(*exc)
        return False


def region(name: str):
    """A span named ``name`` under this thread's open span that is also a
    ``record_function`` range of the same name; nothing when this thread
    runs no recorded step."""
    rec = active()
    return _OFF if rec is None else _RegionCtx(rec, name)


class _ReplayCtx:
    """A replay of recorded code: its spans under the step's root, its
    counters dropped."""

    def __init__(self, rec: Recorder):
        self._rec = Recorder(rec._kept, rec.shard, [0], counts=False)

    def __enter__(self) -> Recorder:
        self._prev = active()
        _local.rec = self._rec
        return self._rec

    def __exit__(self, *exc):
        _local.rec = self._prev
        return False


def replay(rec: Optional[Recorder]):
    """Run the calling thread's spans as a replay of code that ran under
    ``rec`` (a checkpointed forward run again in the backward pass, on
    whichever thread): spans recorded under the step's root, counters not;
    nothing when ``rec`` is None."""
    return _OFF if rec is None else _ReplayCtx(rec)


class _StepCtx:
    """The root span of one recorded step (see `step`)."""

    def __init__(self, name: str):
        self._name = name

    def __enter__(self) -> Recorder:
        r = _RECORD
        with r.lock:
            if not r.stretch_open:
                r.ring.clear()
                r.stretch_open = True
            self._kept = _Kept(r.next_id)
            r.next_id += 1
        self._rec = Recorder(self._kept, 0, [])
        self._root = self._rec._begin(self._name)
        _local.rec = self._rec
        return self._rec

    def __exit__(self, exc_type, *exc):
        _local.rec = None
        k = self._kept
        if exc_type is None:
            keys = list(k.tallies)
            if keys:
                vals = torch.stack([
                    getattr(torch.stack(k.tallies[key]), key[1])()
                    for key in keys]).tolist()
                k.counters.update((key[0], int(v))
                                  for key, v in zip(keys, vals))
            k.tallies = {}
            self._rec._end(self._root)
            with _RECORD.lock:
                _RECORD.ring.append(k)
        return False


def step(name: str = "pobp.step"):
    """The root span ``name`` of one step: yields its `Recorder` (also
    this thread's `active` one) when a profiler records, else nothing.
    Device tallies are read when it closes; a step that raises is not
    kept."""
    if not recording():
        _RECORD.stretch_open = False
        return _OFF
    return _StepCtx(name)


class _ShardCtx:
    """A lockstep shard's thread running under a recorded step."""

    def __init__(self, rec: Recorder, index: int):
        self._rec = Recorder(rec._kept, index, [0])

    def __enter__(self) -> Recorder:
        _local.rec = self._rec
        return self._rec

    def __exit__(self, *exc):
        _local.rec = None
        return False


def shard(rec: Optional[Recorder], index: int):
    """Run the calling thread's spans as shard ``index`` of ``rec``'s step,
    under its root span (a lockstep shard's thread); nothing when ``rec``
    is None."""
    return _OFF if rec is None else _ShardCtx(rec, index)


def steps() -> List[Step]:
    """The recorded steps, oldest first."""
    with _RECORD.lock:
        kept = list(_RECORD.ring)
    return [k.step() for k in kept]


def clear() -> None:
    """Empty the record."""
    with _RECORD.lock:
        _RECORD.ring.clear()
