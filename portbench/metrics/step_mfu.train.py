"""step_mfu.train: the training steps' share of the card's peak, in %:
the least time of the work the algorithm needs on the window's batches
(``portbench/work.py::train_step``, whatever implements it) over the
window's wall time."""


def read(rec):
    t = rec.get("train")
    if not t or not t["steps"] or t["window_s"] <= 0:
        return None
    return 100.0 * sum(s["least_s"] for s in t["steps"]) / t["window_s"]
