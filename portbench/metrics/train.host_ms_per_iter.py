"""train.host_ms_per_iter: the host's milliseconds in one selective
iteration of the training step (``core/pobp.py``): the traced steps'
``pobp.iter`` spans (selection, sweep and refresh enqueued; the host read
of the mean residual is a span of its own, outside them) over their
selective iterations, from the program's record of the traced steps
(``portbench/program_record.py``)."""

from portbench.program_record import traced_steps


def read(rec):
    steps = traced_steps(rec)
    if steps is None:
        return None
    iters = sum(s.counters["selective_iters"] for s in steps)
    ns = sum(sp.end_ns - sp.start_ns for s in steps for sp in s.spans
             if sp.name == "pobp.iter")
    return 1e-6 * ns / iters if iters else None
