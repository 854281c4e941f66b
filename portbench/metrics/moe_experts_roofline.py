"""moe_experts_roofline: the held experts' share of their roofline, in %:
their three products over the rows the program counted
(``portbench/lm_work.py::experts_region_flops``, the forward and its run
again in the backward) at the H100's dense bfloat16 rate, over the device
time of the operations under the program's ``lm.moe.experts`` region in
the traced steps."""

from portbench import lm_work


def read(rec):
    lm, r = rec.get("lm"), rec.get("trace")
    busy = (r or {}).get("regions", {}).get("lm.moe.experts")
    if not lm or not lm["counters"] or not busy:
        return None
    s = lm_work.as_shape(lm["shape"])
    flops = sum(lm_work.experts_region_flops(s, c["moe_rows"])
                for c in lm["counters"])
    return 100.0 * flops / lm_work.BF16_FLOPS_PER_S / busy
