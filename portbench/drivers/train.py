"""Training cells: streaming POBP through the port's step
(``repro_torch.core.pobp.make_train_step``, one shard), fed one mini-batch
after another from a pool made in set-up and kept on the device.

Set-up makes the model and the pool from the seed, builds the step and its
state (phi_acc = phi_true.T * scale, a model that keeps streaming) and
drives the first ``checked_steps`` steps through the same call the window
makes; their outputs are kept on the host for the check.  The window then
runs step after step on the same state for ``seconds``; each step ends in
its own host read (the mean residual).  Its last step, the one that closes
the window, is checked too: the statistic it started from is kept, and its
outputs once the window has closed.  After the window the program's state
is freed and the plain reference follows the checked set-up steps from the
same model, batches and random fields, and the closing step from the
statistic it started from, with its random field drawn again from the
seed.
"""

from __future__ import annotations

import time

import torch

from portbench import check, gen, seeds, trace, work
from portbench.reference import pobp as ref


def _batch_counts(wid: torch.Tensor, cnt: torch.Tensor, P: int) -> dict:
    """What the work counts need of one [D, L] batch, and its words."""
    counted = cnt > 0
    words, per_word = torch.unique(wid[counted], return_counts=True)
    return dict(tokens=int(counted.sum()), docs=int(wid.shape[0]),
                words=int(words.numel()), rows=words.long(),
                power_tokens_min=work.min_power_tokens(per_word, P),
                counted_tokens=float(cnt.sum()))


def _unchanged_elsewhere(new: torch.Tensor, old: torch.Tensor,
                         rows: torch.Tensor, block: int = 8192) -> int:
    """Rows outside ``rows`` where ``new`` differs from ``old``."""
    W = new.shape[0]
    touched = torch.zeros(W, dtype=torch.bool, device=new.device)
    touched[rows] = True
    changed = 0
    for w0 in range(0, W, block):
        diff = (new[w0:w0 + block] != old[w0:w0 + block]).any(dim=1)
        changed += int((diff & ~touched[w0:w0 + block]).sum())
    return changed


def algo_cfg(config: dict) -> dict:
    return {k: config[k] for k in ("alpha", "beta", "lambda_w",
                                   "lambda_k_abs", "inner_iters",
                                   "residual_tol")}


def make_inputs(spec: dict, seed: int, device, mark=lambda name: None):
    """The model and the pool of batches, made on ``device`` from the
    seed: (phi_acc [W, K], [(word_ids, counts)], phi_acc's fingerprint).
    ``mark(name)`` is called as each part is made."""
    c, tr = spec["config"], spec["traffic"]
    W, K = c["vocab_size"], c["num_topics"]
    D, L = c["minibatch_docs"], c["doc_slots"]
    g = torch.Generator(device=device).manual_seed(seeds.derive(seed, "data"))
    phi_true, phi_acc = gen.make_model(g, W, K, conc=c["weights_conc"],
                                       zipf=c["weights_zipf"],
                                       scale=c["weights_scale"])
    mark("model")
    pool = int(tr["pool_batches"])
    # every batch holds the same set of lengths, in its own order
    lens = torch.cat([gen.doc_lengths(g, D, mean=tr["doc_len_mean"],
                                      sigma=tr["doc_len_sigma"],
                                      minimum=tr["doc_len_min"])
                      for _ in range(pool)])
    docs = gen.make_docs(g, phi_true, lens, theta_conc=tr["theta_conc"])
    del phi_true
    batches = [gen.padded(docs, i * D, D, L) for i in range(pool)]
    mark("documents")
    return phi_acc, batches, float(phi_acc.sum(dtype=torch.float64))


def _model(spec: dict, seed: int, device, fingerprint: float):
    """The model made again from the seed, checked against the one the
    program was given."""
    c = spec["config"]
    g = torch.Generator(device=device).manual_seed(seeds.derive(seed, "data"))
    _, phi0 = gen.make_model(g, c["vocab_size"], c["num_topics"],
                             conc=c["weights_conc"], zipf=c["weights_zipf"],
                             scale=c["weights_scale"])
    if float(phi0.sum(dtype=torch.float64)) != fingerprint:
        raise RuntimeError("the model made again from the seed differs from "
                           "the one the program was given")
    return phi0


def reference_steps(steps: int, batches: list, spec: dict, seed: int,
                    device, fingerprint: float, dtype=torch.float32):
    """The reference's checked steps from the model made again from the
    seed, with the same batches and random fields: yields (phi_acc before,
    phi_acc after, theta) a step.  ``dtype`` runs it narrower (the
    control)."""
    c = spec["config"]
    K, D, L = c["num_topics"], c["minibatch_docs"], c["doc_slots"]
    prev = _model(spec, seed, device, fingerprint)
    g = torch.Generator(device=device).manual_seed(seeds.derive(seed, "init"))
    for i in range(steps):
        wid, cnt = batches[i % len(batches)]
        new, theta, _ = ref.minibatch(prev, wid, cnt,
                                      ref.init_messages(g, D, L, K),
                                      algo_cfg(c), dtype=dtype)
        yield prev, new, theta
        prev = new


def follow(kept: list, batches: list, spec: dict, seed: int, device,
           fingerprint: float) -> list:
    """The numbers of `check` a step: the reference's checked set-up steps
    against the ``kept`` outputs."""
    return [check.train_step_numbers(k, prev, new, theta)
            for k, (prev, new, theta) in zip(kept, reference_steps(
                len(kept), batches, spec, seed, device, fingerprint))]


def follow_closing(closing: dict, batches: list, spec: dict, seed: int,
                   device) -> dict:
    """The numbers of `check` for the step that closed the window: the
    reference's step from the statistic that step started from (the
    program's, after the window's steps), over the same batch, with the
    random field of the same draw of the seed's stream."""
    c = spec["config"]
    K, D, L = c["num_topics"], c["minibatch_docs"], c["doc_slots"]
    g = torch.Generator(device=device).manual_seed(seeds.derive(seed, "init"))
    for _ in range(closing["index"]):      # the draws of the earlier steps
        torch.rand((D, L, K), generator=g, device=device)
    wid, cnt = batches[closing["batch"]]
    prev = closing["prev"].to(device)
    new, theta, _ = ref.minibatch(prev, wid, cnt,
                                  ref.init_messages(g, D, L, K), algo_cfg(c))
    return check.train_step_numbers(closing["kept"], prev, new, theta)


def keep(new: torch.Tensor, prev: torch.Tensor, theta: torch.Tensor,
         rows: torch.Tensor) -> dict:
    """What the check keeps of a step's outputs (on the host)."""
    return dict(rows=rows.cpu(), phi_rows=new[rows].float().cpu(),
                theta=theta.float().cpu(),
                untouched_changed=_unchanged_elsewhere(new, prev, rows))


def _notes(phases: dict, built: list, steps: list, window_s: float) -> list:
    """What the run's last lines on standard error say besides the
    check: where set-up went (the port's kernels built in this run apart),
    and the window's steps."""
    it = sorted(s["iters"] for s in steps)
    ms = sorted(1e3 * s["wall_s"] for s in steps)
    mid = len(steps) // 2
    return ["set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                  phases.items()),
            (f"kernels built in this run, in its first step's "
             f"{phases['first_step']:.3f} s: {', '.join(built)}" if built
             else "kernels: none built in this run, all loaded as built"),
            f"window {window_s:.3f} s, {len(steps)} steps; min / median / "
            f"max: iterations a step {it[0]} / {it[mid]} / {it[-1]}, ms a "
            f"step {ms[0]:.1f} / {ms[mid]:.1f} / {ms[-1]:.1f}"]


def run(spec: dict, *, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, program=None, control=None) -> dict:
    """One run of a training cell; ``program`` injects the step maker
    (tests break it underneath); ``control`` (a dtype) also reads the
    control: the reference at that width in the program's place."""
    from repro_torch.core.pobp import make_train_step
    from repro_torch.core.types import LDAConfig, LDATrainState
    from repro_torch.kernels import build as kernel_build

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = {}
    t_last = t_start

    def mark(name: str) -> None:
        nonlocal t_last
        if cuda:
            torch.cuda.synchronize(dev)
        t_now = time.time()
        phases[name] = t_now - t_last
        t_last = t_now

    if cuda:
        torch.empty(1, device=dev)
    mark("start_imports_context")
    c, par = spec["config"], spec["params"]
    W, K = c["vocab_size"], c["num_topics"]
    P = max(1, int(round(c["lambda_w"] * W)))
    Pk = max(1, min(int(c["lambda_k_abs"]), K))
    phi_acc, batches, fingerprint = make_inputs(spec, seed, dev, mark)
    counts = [_batch_counts(w, n, P) for w, n in batches]
    pool = len(batches)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    mark("batch_counts")

    cfg = LDAConfig(vocab_size=W, num_topics=K, alpha=c["alpha"],
                    beta=c["beta"], lambda_w=c["lambda_w"],
                    lambda_k_abs=c["lambda_k_abs"],
                    inner_iters=c["inner_iters"],
                    residual_tol=c["residual_tol"],
                    phi_acc_dtype=c["phi_acc_dtype"],
                    sweep_policy=par["sweep_policy"])
    step, _meter = (program or make_train_step)(cfg, device=dev)
    init_seed = seeds.derive(seed, "init")
    state = LDATrainState(phi_acc=phi_acc, m=0, generator=torch.Generator(
        device=dev).manual_seed(init_seed))
    del phi_acc

    # set-up: the checked steps, through the window's own call; the first
    # builds whatever kernel of the port is not built in this checkout yet
    libs = set(kernel_build.BUILD.glob("lib*.so"))
    n_check = int(par["checked_steps"])
    kept = []
    for i in range(n_check):
        wid, cnt = batches[i % pool]
        old = state.phi_acc
        state, diag = step(state, wid, cnt)
        float(diag["mean_r"])
        kept.append(keep(state.phi_acc, old, diag["theta"],
                         counts[i % pool]["rows"]))
        del old, diag
        if i == 0:
            mark("first_step")
    built = sorted(p.name for p in set(kernel_build.BUILD.glob("lib*.so"))
                   - libs)
    mark("checked_steps")
    setup_s = t_last - t_start

    def run_steps(first: int, seconds: float, spans: bool,
                  close: bool = False):
        """Steps one after another for ``seconds``, each ended by its host
        read (the mean residual).  With ``close``, the step that is
        expected to end past ``seconds`` (by the last one's time) is the
        last, and what its check needs is returned with the steps."""
        nonlocal state
        out, closing = [], None
        t0 = t_prev = time.time()
        last_wall = 0.0
        i = first
        while True:
            b = i % pool
            wid, cnt = batches[b]
            last = close and t_prev - t0 + last_wall >= seconds
            old = state.phi_acc if last else None
            with trace.span("pb.train.step", spans):
                state, diag = step(state, wid, cnt)
                float(diag["mean_r"])
            t_now = time.time()
            out.append(dict(wall_s=t_now - t_prev, iters=int(diag["iters"]),
                            batch=b))
            if last:
                closing = dict(index=i, batch=b, prev=old,
                               theta=diag["theta"])
            del diag, old
            last_wall = t_now - t_prev
            t_prev = t_now
            i += 1
            if last or (not close and t_now - t0 >= seconds):
                return out, closing

    # the window; with tracing, a profiled slice of further steps after it
    steps, closing = run_steps(n_check, seconds, False, close=True)
    window_s = sum(s["wall_s"] for s in steps)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    closing["kept"] = keep(state.phi_acc, closing["prev"],
                           closing.pop("theta"),
                           counts[closing["batch"]]["rows"])
    closing["prev"] = closing["prev"].cpu()
    tracer = trace.Tracer(trace_on, dev)
    traced = []
    if trace_on:
        with tracer:
            traced, _ = run_steps(n_check + len(steps),
                                  float(par["trace_seconds"]), True)
    reading = tracer.reading()
    del state, step
    if cuda:
        torch.cuda.empty_cache()

    for s in steps + traced:
        n = counts[s["batch"]]
        s["tokens"] = n["counted_tokens"]
        s["least_s"] = work.train_step(
            tokens=n["tokens"], words=n["words"], docs=n["docs"], K=K,
            iters=s["iters"], power_tokens_min=n["power_tokens_min"], P=P,
            Pk=Pk).least_s()
        s["dense_least_s"] = work.dense_sweep(
            n["tokens"], n["words"], n["docs"], K).least_s()
    tokens = sum(s["tokens"] for s in steps)
    numbers = check.worst(
        follow(kept, batches, spec, seed, dev, fingerprint)
        + [follow_closing(closing, batches, spec, seed, dev)])
    result = check.verdict(numbers, spec["limits"])
    if control is not None:
        kept = [keep(new, prev, theta, counts[i % pool]["rows"])
                for i, (prev, new, theta) in enumerate(reference_steps(
                    n_check, batches, spec, seed, dev, fingerprint,
                    dtype=control))]
        result["control"] = check.worst(
            follow(kept, batches, spec, seed, dev, fingerprint))
    return dict(
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        attempted=n_check + len(steps) + len(traced), failed=0,
        train=dict(steps=steps, window_s=window_s, traced=traced),
        trace=reading,
        breakdown=reading["breakdown"] if reading else None,
        check=result, peak_bytes=peak,
        notes=_notes(phases, built, steps, window_s))
