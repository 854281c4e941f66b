"""bp_update_roofline: the dense sweep kernel's share of its roofline, in
%: the least time of the dense sweeps of the traced steps
(``portbench/work.py::dense_sweep``) over the device time of the
kernels named ``bp_update*`` in their trace (one launch a step)."""

from portbench.trace import device_seconds


def read(rec):
    t = rec.get("train")
    busy = device_seconds(rec.get("trace"), "bp_update")
    if not t or not t["traced"] or not busy:
        return None
    return 100.0 * sum(s["dense_least_s"] for s in t["traced"]) / busy
