"""mla_attend_roofline: causal attention's share of its roofline, in %:
the scores and values of every layer's forward and of the checkpointed
layers' run again in the backward (``portbench/lm_work.py::
attend_region_flops``) at the H100's dense bfloat16 rate, over the device
time of the operations under the program's ``lm.mla.attend`` region in
the traced steps."""

from portbench import lm_work


def read(rec):
    lm, r = rec.get("lm"), rec.get("trace")
    busy = (r or {}).get("regions", {}).get("lm.mla.attend")
    if not lm or not lm["traced"] or not busy:
        return None
    s = lm_work.as_shape(lm["shape"])
    flops = lm_work.attend_region_flops(s) * len(lm["traced"])
    return 100.0 * flops / lm_work.BF16_FLOPS_PER_S / busy
