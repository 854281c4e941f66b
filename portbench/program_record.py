"""The program's own record of the traced steps (``repro_torch.obs``), for
the metric readers that read its spans and counters.  The record holds the
steps of the latest stretch of profiling; the traced slice is the only one
in a run, so it is read only when it holds exactly the traced steps."""

from __future__ import annotations

from typing import Optional


def traced_steps(rec: dict) -> Optional[list]:
    """The recorded steps of the run's traced slice, or None: when the run
    has no traced slice, when the program keeps no record (a version
    without ``repro_torch.obs``), or when the record does not hold exactly
    the traced steps."""
    traced = rec.get("train", {}).get("traced")
    if traced is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    steps = obs.steps()
    return steps if len(steps) == len(traced) else None
