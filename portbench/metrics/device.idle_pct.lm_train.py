"""device.idle_pct.lm_train: the share of the traced LM training slice in
which no operation ran on the device, in %."""


def read(rec):
    r = rec.get("trace")
    if "lm" not in rec or not r or r["window_s"] <= 0 or r["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
