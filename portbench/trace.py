"""The traced run's readings: spans the benchmark records around its calls
into the program, and what the profiler saw on the device.

Spans are ``torch.profiler.record_function`` ranges named ``pb.*`` opened
by the benchmark's own code (the program has none yet).  From the
profiler's events the reader takes:

  - ``busy_s``: the union of the device's operation intervals (kernels,
    copies, fills) inside the traced window, and ``window_s`` its length;
  - ``kernels``: device seconds and launches by operation name;
  - ``idle_gaps``: the device's idle time inside the window, by the
    benchmark span that the host was in at the middle of each gap
    (``outside spans`` when none).

The profiler's CPU-side recording slows a host-bound loop, so a traced
run profiles a slice after its window, and the host-clock metrics come
from the window.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Optional


def span(name: str, enabled: bool):
    """A ``pb.*`` range in the profiler's trace (nothing when tracing is
    off)."""
    if not enabled:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


class Tracer:
    """Profiles the window when ``enabled``; `reading` afterwards."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reading(self) -> Optional[dict]:
        """The window's device reading, or None when not traced."""
        if self.prof is None:
            return None
        return read_events(self.prof.events(), self.t1 - self.t0)


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_events(events, wall_s: float) -> dict:
    """Busy time, device operations by name and idle gaps by span from a
    profiler's ``events()`` (times in microseconds on one clock).  The
    window runs from the first to the last benchmark span; device time
    outside it is not counted."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith("pb."):
            # the benchmark's ranges (their device-side copies, the
            # profiler's GPU annotations, are not device work)
            if e.device_type != DeviceType.CUDA:
                spans.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
    if spans:
        w0 = min(s for s, _, _ in spans)
        w1 = max(e for _, e, _ in spans)
    else:
        w0 = min((s for s, _, _ in dev), default=0.0)
        w1 = w0 + wall_s * 1e6
    kernels = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _ in dev
                   if e > w0 and s < w1])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # the benchmark's spans do not nest: the last one to start before a
    # gap's middle is the only one that can hold it
    spans.sort()
    starts = [s for s, _, _ in spans]
    by_span = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = (spans[i][2] if i >= 0 and spans[i][1] >= mid
                else "outside spans")
        by_span[name] = by_span.get(name, 0.0) + (g1 - g0) / 1e6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) / 1e6,
        "kernels": {n: {"s": v[0], "launches": v[1]}
                    for n, v in kernels.items()},
        "breakdown": {
            "device_ops": [[n, v[0]] for n, v in top_ops],
            "idle_gaps": sorted(([n, s] for n, s in by_span.items()),
                                key=lambda x: -x[1])[:10]},
    }


def device_seconds(reading: Optional[dict], needle: str) -> Optional[float]:
    """Device seconds of the operations whose name holds ``needle``, or
    None when none ran in the trace."""
    if not reading:
        return None
    hits = [v["s"] for n, v in reading["kernels"].items() if needle in n]
    return sum(hits) if hits else None
