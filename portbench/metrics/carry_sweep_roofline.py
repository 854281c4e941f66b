"""carry_sweep_roofline: the carry sweep's share of its roofline, in %: the
least time of the traced steps' selective sweeps
(``portbench/work.py::selective_iteration`` at each recorded step's mean
count of power tokens a sweep, times its selective sweeps) over the device
time of the kernels named ``carry_*`` in their trace (the carry sweep and
its d/r fold, ``csrc/power_sweep_carry.cu``).  The counts come from the
program's record of the traced steps (``portbench/program_record.py``)."""

from portbench import work
from portbench.program_record import traced_steps
from portbench.trace import device_seconds


def read(rec):
    steps = traced_steps(rec)
    if steps is None:
        return None
    least = sum(work.selective_iteration(
        c["power_tokens"] / c["selective_iters"], c["P"], c["Pk"]).scaled(
            c["selective_iters"]).least_s()
        for c in (s.counters for s in steps) if c["selective_iters"])
    busy = device_seconds(rec.get("trace"), "carry_")
    if not least or not busy:
        return None
    return 100.0 * least / busy
