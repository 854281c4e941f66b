"""train.iter_ms: milliseconds an iteration of the training step
(``core/pobp.py``): the window's step walls over its iterations (the
dense one included), as the steps' ``diag["iters"]`` count them."""


def read(rec):
    steps = rec.get("train", {}).get("steps")
    if not steps:
        return None
    iters = sum(s["iters"] for s in steps)
    return 1e3 * sum(s["wall_s"] for s in steps) / iters if iters else None
