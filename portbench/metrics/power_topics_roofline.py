"""power_topics_roofline: the power-topic selection's share of its
roofline, in %: the least time of the traced steps' selections (each
selective iteration reads its P selected [K] residual rows and the P word
ids once and writes the [P, Pk] topic ids once: 4 * P * (K + 1 + Pk)
bytes, at the card's memory rate) over the device time of the kernel
named ``power_topics`` in the trace (``csrc/power_topics.cu``).  The
counts come from the program's record of the traced steps
(``portbench/program_record.py``); a program without that kernel, or
whose record has no ``K``, leaves the metric out."""

from portbench.program_record import traced_steps
from portbench.trace import device_seconds
from portbench.work import HBM_BYTES_PER_S


def read(rec):
    busy = device_seconds(rec.get("trace"), "power_topics")
    steps = traced_steps(rec)
    if not busy or steps is None:
        return None
    counters = [s.counters for s in steps]
    if any("K" not in c for c in counters):
        return None
    nbytes = sum(c["selective_iters"] * 4 * c["P"] * (c["K"] + 1 + c["Pk"])
                 for c in counters)
    if not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / busy
