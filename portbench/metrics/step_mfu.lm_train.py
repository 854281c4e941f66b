"""step_mfu.lm_train: the LM training steps' share of the card's bf16 peak,
in %: the model FLOPs of the window's steps (``portbench/lm_work.py::
step_flops``, forward and backward, the held experts at the rows the
program counted a step, the traced steps' mean) over the window's wall
time, at the H100's dense bfloat16 rate."""

from portbench import lm_work


def read(rec):
    lm = rec.get("lm")
    if not lm or not lm["steps"] or not lm["counters"] or \
            lm["window_s"] <= 0:
        return None
    s = lm_work.as_shape(lm["shape"])
    rows = sum(c["moe_rows"] for c in lm["counters"]) / len(lm["counters"])
    flops = sum(lm_work.step_flops(s, rows) * st["tokens"] / s.tokens
                for st in lm["steps"])
    return 100.0 * flops / lm_work.BF16_FLOPS_PER_S / lm["window_s"]
