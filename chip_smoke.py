"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py [--seed 0] [--requests 512] [--bursts 9]
                          [--train-steps 3]

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

  1. build every CUDA kernel of the port from ``src/repro_torch/csrc``
     (one ``nvcc`` per source, in parallel) and print the card's name and
     power limit;
  2. hold each kernel against its plain PyTorch version on the card at its
     slice's shapes and at odd shapes, and time both, with the bound of
     the work and, where one PyTorch call computes the same function, that
     call's time: the serving sweep on both of its paths (the register
     path to K = 2048, the K-blocked path past it: K = 2049, 8192, 8193,
     10,000, 20,001; timed at K = 10,000 at the slab's shapes); the
     packed sweep repeating bit for bit, and timed again with
     Zipf-like rows and one very long row; the phi pack timed in turns
     with its library call, which it may not exceed; the row scatter
     timed in turns with its library call, with the L2 flushed (where it
     may not exceed it) and warm; the dense sweep on both of its paths
     (registers to K = 2048, two passes past it: K = 100, 1999, 2000,
     10,000), its register path timed in turns with its two-pass path at
     the training slice's shapes, which it may not exceed; the carry
     training sweep repeating all four outputs bit for bit (its d/r sums
     run in a fixed order since the fold kernel); the two fixed-order sums
     the port adds (the word-row scatter, bit for bit against its plain
     version on the CPU and timed in turns with ``index_add_`` with and
     without PyTorch's deterministic algorithms; the phi_tot refresh's
     per-topic sum), each repeating bit for bit;
  3. the serving slice at PUBMED width (W = 141,043, K = 2000): a random
     phi statistic made on the card from ``--seed``, saved as a JAX-format
     checkpoint, served by ``SlabEngine.from_checkpoint`` for
     ``--requests`` documents sampled on the card from the model; every
     request must retire with a finite theta that sums to 1, and the
     kernel's launch count must equal slab steps x sweeps per step; then
     the same requests again, closed loop, until ``--bursts`` bursts are
     served in all, and the median and range of each burst's docs/s, p50,
     p99 and step_ema;
     then 64 requests at K = 10,000 (W cut to 20,000) from a checkpoint
     the port wrote, through the K-blocked path, with the same checks;
  4. a fixed-sweep fold-in through the kernel against the plain version;
  5. the same requests served again under ``torch.profiler``: the card's
     busy share of the wall time and the device time by kernel;
  6. the training slice at PUBMED width (W = 141,043, K = 2000, mini-batches
     of D = 512 documents x L = 128 sampled on the card from a random
     model): ``--train-steps`` POBP steps of ``make_train_step`` with the
     repo's paper-scale settings (lambda_w 0.1, 50 power topics, 200 inner
     iterations, tolerance 0.1); the launch counts of the three training
     kernels must match the steps and iterations run, phi_acc must hold
     every token consumed and stay finite; one mini-batch at a reduced
     shape through the kernels and through their plain versions must agree
     in phi_acc and theta (relative L1 gap 1e-4); one step with the
     Robbins-Monro decay on at that shape, whose byte meter must bill the
     decay pass (W * K * 4 bytes); one mini-batch run twice from one state
     (the generator's state put back), equal bit for bit in phi_acc,
     theta, mean_r and iterations; then held-out perplexity after the last
     step, and one more step under ``torch.profiler`` (with the device
     time a launch of the dense sweep, the carry sweep, the scatter and
     the fixed-order sums);
  7. the packed sweep policy on the same batches and settings: the same
     steps with ``sweep_policy="packed"`` (the phi pack and packed-sweep
     kernels launch once per selective iteration, the carry sweep never),
     the same mass and finiteness checks, the same bit-for-bit repeat of
     one mini-batch, one profiled step (with the
     device time a launch of the dense sweep, the pack, the packed
     sweep's two kernels and the scatter); then one
     mini-batch from one injected init through both policies with
     tolerance 0 and 8 iterations, at a reduced shape (phi_acc and theta
     must agree to a relative L1 gap of 1e-4) and at the full width (the
     two formulations' ms per iteration side by side, in turns);
  8. the training driver (``launch/lda_train.train_loop``) at PUBMED width
     with the paper-scale settings, ``--driver-docs`` documents a
     mini-batch drawn on the host: 4 mini-batches with a checkpoint every
     2; the same in a fresh directory with ``--crash-at 3`` (it must end by
     SystemExit), then again, resuming at m = 2 and ending equal to the
     uninterrupted run bit for bit (mean_r, iterations, phi_acc); the
     uninterrupted run with a bf16 phi_acc (bf16, finite, non-negative;
     its mean_r gap printed; its peak device memory no higher than the
     float32 run's), and 64 requests served in float32 from its
     checkpoint; the uninterrupted run once more with ``--prefetch 0``
     (no draw thread beside the steps), equal to it bit for bit.  The
     warmed steps' walls, the checkpoints' save and restore seconds and
     the kernels' launches net of the warm-up are printed.

Each phase prints its wall time.  The line before the last is the
kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores
L2_FLUSH_BYTES = 128 << 20       # > the card's 50 MB L2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, make_args, reps: int = 20) -> float:
    """Median device time of ``fn(*make_args())`` over ``reps`` runs (see
    `time_turns`)."""
    return time_turns({"fn": (fn, make_args)}, reps)["fn"]


def time_turns(fns: dict, reps: int = 20, warm=None) -> dict:
    """Median device time of each ``fn(*make_args())`` of ``fns`` (name ->
    (fn, make_args)) over ``reps`` rounds, the entries timed in turn within
    each round: CUDA events around each call, the L2 flushed before each
    (arguments are made outside the timed region) and, with ``warm``,
    ``warm()`` run after the flush and outside the timed region, as the
    main path runs the work before.  The card sleeps ~0.5 ms before the
    start event, so the host has queued the call by the time the card
    reaches it: the time is the card's, not the host's enqueue."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for fn, make_args in fns.values():
        fn(*make_args())                                # warm up
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, (fn, make_args) in fns.items():
            args = make_args()
            flush.zero_()
            if warm is not None:
                warm()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


# --------------------------------------------------------------- phase 2

def sweep_inputs(gen, *, T, D, K, rows, frozen, empty_docs):
    """Inputs of one serving sweep: doc-contiguous tokens, ragged document
    lengths (padding tokens carry c = 0), a ``frozen`` share of tokens and
    ``empty_docs`` whole slots on the guard id."""
    import torch

    L = T // D
    dev = "cuda"
    p_tok = torch.randint(0, rows, (T,), generator=gen, device=dev,
                          dtype=torch.int32)
    lens = torch.randint(1, L + 1, (D,), generator=gen, device=dev)
    pos = torch.arange(L, device=dev).repeat(D)
    c = torch.randint(1, 4, (T,), generator=gen, device=dev).float()
    c = torch.where(pos < lens.repeat_interleave(L), c, 0.0)
    froz = torch.rand(T, generator=gen, device=dev) < frozen
    doc_ids = torch.arange(D, device=dev, dtype=torch.int32
                           ).repeat_interleave(L)
    froz |= doc_ids >= D - empty_docs
    c = torch.where(doc_ids >= D - empty_docs, 0.0, c)
    p_tok = torch.where(froz, rows, p_tok).to(torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev) + 0.01
    mu /= mu.sum(1, keepdim=True)
    counts = c.reshape(T, 1).contiguous()
    theta = torch.zeros((D, K), device=dev).index_add_(
        0, doc_ids.long(), counts * mu)
    phi = torch.rand((rows, K), generator=gen, device=dev)
    phi /= phi.sum(0, keepdim=True)
    return dict(p_tok=p_tok, doc_ids=doc_ids, counts_t=counts, mu_t=mu,
                theta=theta, phi_tot=torch.zeros(K, device=dev),
                phi_rows=phi, n_guard=rows)


def bound_ms(nbytes: float, flops: float):
    """The least time for the work: the larger of its bytes over the card's
    memory rate and its f32 operations over the card's f32 rate, and which
    of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def kernel_record(name, source, replaces, err, ms, plain_ms, bound, bound_by,
                  library_ms=None, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **extra, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}


def sweep_bound_ms(x):
    """Least time for one serving sweep on these inputs, and what bounds
    it: the larger of the bytes it must move (active tokens' mu read and
    written, each distinct phi row they read, the per-token ids and counts,
    theta in, theta delta and rdoc out) over the card's memory rate, and
    its ~14 f32 operations per active element over the card's f32 rate."""
    import torch

    T, K = x["mu_t"].shape
    D = x["theta"].shape[0]
    p = x["p_tok"]
    act = (p != x["n_guard"]) & (p >= 0) & (p < x["phi_rows"].shape[0])
    n_act = int(act.sum())
    n_rows = int(torch.unique(p[act]).numel())
    return bound_ms(4 * (2 * n_act * K + n_rows * K + 3 * T + 2 * D * K + K
                         + D), 14 * n_act * K)


def check_sweep(ops, gen, *, T, D, K, rows, frozen, empty_docs, timed,
                suffix=""):
    """The serving sweep against its plain version: mu' within 1e-5,
    theta_delta and rdoc within rel 1e-4; a second launch on the same
    inputs repeats mu', theta_delta and rdoc bit for bit.  Timed, returns
    the kernel's record, or with ``suffix`` only its times and bound under
    keys ending in it."""
    import torch

    x = sweep_inputs(gen, T=T, D=D, K=K, rows=rows, frozen=frozen,
                     empty_docs=empty_docs)
    kw = dict(alpha=0.1, beta=0.0, wbeta=1.0, n_guard=x["n_guard"])
    args = [x["p_tok"], x["doc_ids"], x["counts_t"], x["mu_t"], x["theta"],
            x["phi_tot"], x["phi_rows"]]

    def with_fresh_mu():
        a = list(args)
        a[3] = x["mu_t"].clone()
        return a

    got = ops.power_sweep_carry(*with_fresh_mu(), **kw)
    again = ops.power_sweep_carry(*with_fresh_mu(), **kw)
    want = ops.power_sweep_carry_plain(*with_fresh_mu(), **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel = [rel_err(got[i], want[i]) for i in (1, 2)]
    same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
    print(f"[kernel] power_sweep_carry T={T} D={D} K={K} rows={rows} "
          f"path={ops.serve_launch_plan(K).path}: "
          f"max|dmu'|={err_mu:.3e} (tol 1e-5)  rel dtheta={rel[0]:.3e}  "
          f"rel rdoc={rel[1]:.3e} (tol 1e-4)  relaunch bit for bit: {same}")
    if not (err_mu <= 1e-5 and max(rel) <= 1e-4 and same):
        fail(f"power_sweep_carry disagrees with its plain version at "
             f"T={T} D={D} K={K}")
    if not timed:
        return None
    ms = time_ms(lambda *a: ops.power_sweep_carry(*a, **kw), with_fresh_mu)
    plain_ms = time_ms(lambda *a: ops.power_sweep_carry_plain(*a, **kw),
                       with_fresh_mu)
    bound, bound_by = sweep_bound_ms(x)
    print(f"[kernel] power_sweep_carry K={K}: {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {bound * 1e3:.2f} us ({bound_by})  "
          f"library: none (no single PyTorch call computes this sweep)")
    if suffix:
        return {f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                f"bound_ms{suffix}": bound}
    return kernel_record(
        "power_sweep_carry", "src/repro_torch/csrc/power_sweep_carry.cu",
        "src/repro/kernels/power_sweep/kernel.py:363", err_mu, ms, plain_ms,
        bound, bound_by,
        also_replaces="src/repro/kernels/power_sweep/kernel.py:523")


def doc_tokens(gen, *, D, L, ragged):
    """doc_ids [D*L] and counts [D*L, 1] of doc-contiguous tokens; with
    ``ragged`` the last document keeps only its first half (c = 0 after)."""
    import torch

    dev = "cuda"
    doc_ids = torch.arange(D, device=dev, dtype=torch.int32
                           ).repeat_interleave(L)
    c = torch.randint(1, 4, (D * L,), generator=gen, device=dev).float()
    if ragged:
        pos = torch.arange(L, device=dev).repeat(D)
        c = torch.where((doc_ids == D - 1) & (pos >= L // 2), 0.0, c)
    return doc_ids, c.reshape(-1, 1).contiguous()


def bp_inputs(gen, *, D, L, K, W, ragged, junk_pad_mu=False):
    """Inputs of one dense (t=1) sweep: random messages, theta = sum c*mu,
    phi a random statistic plus this batch's c*mu; with ``junk_pad_mu`` the
    count-0 slots' mu is not a distribution (finite, some of it negative),
    which the sweep must ignore."""
    import torch

    dev = "cuda"
    T = D * L
    doc_ids, counts = doc_tokens(gen, D=D, L=L, ragged=ragged)
    word_ids = torch.randint(0, W, (T,), generator=gen, device=dev,
                             dtype=torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev) + 0.01
    mu /= mu.sum(1, keepdim=True)
    if junk_pad_mu:
        pad = counts[:, 0] == 0
        mu[pad] = torch.rand((int(pad.sum()), K), generator=gen,
                             device=dev) * 7 - 2
    theta = torch.zeros((D, K), device=dev).index_add_(0, doc_ids.long(),
                                                       counts * mu)
    phi = torch.rand((W, K), generator=gen, device=dev).index_add_(
        0, word_ids.long(), counts * mu)
    return [word_ids, doc_ids, counts, mu, theta, phi, phi.sum(0)]


def bp_bound_ms(x):
    """Least time for one dense sweep on these inputs, and what bounds it:
    mu read at the counted tokens (a count-0 token's update does not
    depend on it), mu' and r written, each distinct phi and theta row read,
    phi_tot and the per-token ids and counts; ~12 f32 operations per
    element."""
    import torch

    word_ids, doc_ids, counts, mu = x[:4]
    T, K = mu.shape
    n_counted = int((counts != 0).sum())
    n_rows = (int(torch.unique(word_ids).numel())
              + int(torch.unique(doc_ids).numel()))
    return bound_ms(4 * ((n_counted + 2 * T) * K + (n_rows + 1) * K + 3 * T),
                    12 * T * K)


def check_bp_update(ops, gen, *, D, L, K, W, ragged, timed, twopass=False,
                    junk_pad_mu=False):
    """The dense sweep against its plain version on the path
    ``bp_launch_plan(K)`` picks, or with ``twopass`` on the two-pass path:
    max |dmu'| <= 1e-5, relative r <= 1e-4; a second launch repeats mu' and
    r bit for bit.  Timed (K <= 2048), the register path and the two-pass
    path in turns, 15 each: the register path's median may not exceed the
    two-pass path's."""
    from unittest import mock

    import torch

    x = bp_inputs(gen, D=D, L=L, K=K, W=W, ragged=ragged,
                  junk_pad_mu=junk_pad_mu)
    kw = dict(alpha=0.1, beta=0.01, wbeta=W * 0.01)

    def run_twopass(*a):
        with mock.patch.object(ops, "bp_launch_plan",
                               lambda K: ops.BpPlan("twopass", 256)):
            return ops.bp_update(*a, **kw)

    run = run_twopass if twopass else (lambda *a: ops.bp_update(*a, **kw))
    path = "twopass" if twopass else ops.bp_launch_plan(K).path
    got = run(*x)
    again = run(*x)
    want = ops.bp_update_plain(*x, **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel_r = rel_err(got[1], want[1])
    same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
    print(f"[kernel] bp_update T={D * L} D={D} K={K} W={W} path={path}: "
          f"max|dmu'|={err_mu:.3e} (tol 1e-5)  rel r={rel_r:.3e} (tol 1e-4)"
          f"  relaunch bit for bit: {same}")
    if not (err_mu <= 1e-5 and rel_r <= 1e-4 and same):
        fail(f"bp_update disagrees with its plain version or itself at D={D} "
             f"L={L} K={K} on the {path} path")
    if not timed:
        return None
    del got, again, want
    med = time_turns({"registers": (run, lambda: x),
                      "twopass": (run_twopass, lambda: x)}, 15)
    ms, twopass_ms = med["registers"], med["twopass"]
    plain_ms = time_ms(lambda *a: ops.bp_update_plain(*a, **kw), lambda: x)
    bound, bound_by = bp_bound_ms(x)
    print(f"[kernel] bp_update: register path {ms:.4f} ms, two-pass path "
          f"{twopass_ms:.4f} ms (medians of 15 in turns; gate: registers <= "
          f"two-pass)  plain {plain_ms:.4f} ms  bound {bound * 1e3:.2f} us "
          f"({bound_by}): {bound / ms:.1%} of it reached  library: none (no "
          f"single PyTorch call computes this sweep)")
    if not ms <= twopass_ms:
        fail(f"bp_update's register path ({ms:.4f} ms) is slower than its "
             f"two-pass path ({twopass_ms:.4f} ms)")
    return kernel_record("bp_update", "src/repro_torch/csrc/bp_update.cu",
                         "src/repro/kernels/bp_update/kernel.py:56", err_mu,
                         ms, plain_ms, bound, bound_by, path=path,
                         ms_twopass=twopass_ms)


def carry_train_inputs(gen, *, D, L, K, W, P, Pk, ragged, guard_share,
                       empty_doc=False):
    """Inputs of one training-mode selective sweep: tokens on P power rows
    or (a ``guard_share`` of them, and with ``empty_doc`` all of document
    0, whose counts are 0) the guard id P; P distinct power words of a
    [W, K] phi and Pk distinct topics for each."""
    import torch

    dev = "cuda"
    T = D * L
    doc_ids, counts = doc_tokens(gen, D=D, L=L, ragged=ragged)
    p_tok = torch.randint(0, P, (T,), generator=gen, device=dev)
    guard = torch.rand(T, generator=gen, device=dev) < guard_share
    if empty_doc:
        guard |= doc_ids == 0
        counts[doc_ids == 0] = 0.0
    p_tok = torch.where(guard, P, p_tok).to(torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev) + 0.01
    mu /= mu.sum(1, keepdim=True)
    theta = torch.zeros((D, K), device=dev).index_add_(0, doc_ids.long(),
                                                       counts * mu)
    phi = torch.rand((W, K), generator=gen, device=dev) * 5
    sel_w = torch.randperm(W, generator=gen, device=dev)[:P].to(torch.int32)
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    phi_tot = phi[sel_w.long()].sum(0) + 30.0
    return [p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k]


def carry_train_runs(x, W):
    """The tokens' runs by word, as the training step makes them once per
    mini-batch (``TokenLayout.word_runs``): a power token's word is its
    row's ``sel_w``, a guard token's a word outside the selection."""
    import torch

    from repro_torch.core.types import token_runs

    p_tok, counts, sel_w = x[0], x[2], x[7]
    P = sel_w.shape[0]
    chosen = torch.zeros(W, dtype=torch.bool, device=p_tok.device)
    chosen[sel_w.long()] = True
    other = int((~chosen).nonzero()[0])
    words = torch.where(p_tok < P, sel_w[p_tok.clamp(max=P - 1).long()],
                        other)
    return token_runs(words, counts, W)


def carry_train_bound_ms(x):
    """Least time for one training sweep on these inputs, and what bounds
    it: each distinct power word's sel_w, sel_k and phi at its Pk topics;
    each power token's mu at its Pk topics, read and written; theta at the
    distinct selected (document, topic) pairs in, theta_delta out; the
    [P, Pk] d/r buffers written once; the per-token ids and counts, and
    the runs' order and two starts a power row; phi_tot; ~30 f32
    operations per (power token, topic)."""
    import torch

    p_tok, doc, theta, sel_k = x[0], x[1], x[4], x[8]
    T = p_tok.shape[0]
    D, K = theta.shape
    P, Pk = sel_k.shape
    act = p_tok < P
    n_act = int(act.sum())
    n_rows = int(torch.unique(p_tok[act]).numel())
    pairs = doc[act].long()[:, None] * K + sel_k.long()[p_tok[act].long()]
    n_dk = int(torch.unique(pairs).numel())
    nbytes = 4 * (n_rows * (1 + 2 * Pk) + 2 * n_act * Pk + n_dk + D * K
                  + 2 * P * Pk + 3 * T + K + n_act + 2 * P)
    return bound_ms(nbytes, 30 * n_act * Pk)


def check_carry_train(ops, gen, *, D, L, K, W, P, Pk, ragged, guard_share,
                      timed, empty_doc=False):
    """The training sweep against its plain version: mu' within 1e-5,
    theta_delta, d_pack and r_pack within rel 1e-4 (the sums' order
    differs); mu outside the power tokens' selections bit for bit as it
    was; a second launch repeats all four outputs bit for bit.  The kernel
    is given the tokens' runs by word, as the training step gives them."""
    import torch

    x = carry_train_inputs(gen, D=D, L=L, K=K, W=W, P=P, Pk=Pk,
                           ragged=ragged, guard_share=guard_share,
                           empty_doc=empty_doc)
    runs = carry_train_runs(x, W)
    kw = dict(alpha=0.1, beta=0.01, wbeta=141043 * 0.01)

    def fresh():
        a = list(x)
        a[3] = x[3].clone()
        return a

    got = ops.power_sweep_carry_train(*fresh(), **kw, runs=runs)
    again = ops.power_sweep_carry_train(*fresh(), **kw, runs=runs)
    want = ops.power_sweep_carry_train_plain(*fresh(), **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel = [rel_err(g, w) for g, w in zip(got[1:], want[1:])]
    off = ~selected_mask(x[3], x[0], x[8], P)
    kept = bool(torch.equal(got[0][off], x[3][off]))
    same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
    print(f"[kernel] power_sweep_carry_train T={D * L} D={D} K={K} P={P} "
          f"Pk={Pk} guard={guard_share}: max|dmu'|={err_mu:.3e} (tol 1e-5)  "
          f"rel dtheta={rel[0]:.3e}  rel d_pack={rel[1]:.3e}  rel r_pack="
          f"{rel[2]:.3e} (tol 1e-4)  untouched bit for bit: {kept}  "
          f"relaunch bit for bit (mu', dtheta, d_pack, r_pack): {same}")
    if not (err_mu <= 1e-5 and max(rel) <= 1e-4 and kept and same):
        fail(f"power_sweep_carry_train disagrees with its plain version, or "
             f"does not repeat bit for bit, at D={D} L={L} K={K} P={P} "
             f"Pk={Pk}")
    if not timed:
        return None
    ms = time_ms(lambda *a: ops.power_sweep_carry_train(*a, **kw, runs=runs),
                 fresh)
    plain_ms = time_ms(lambda *a: ops.power_sweep_carry_train_plain(*a, **kw),
                       fresh)
    bound, bound_by = carry_train_bound_ms(x)
    print(f"[kernel] power_sweep_carry_train: {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {bound * 1e3:.2f} us ({bound_by})  "
          f"library: none (no single PyTorch call computes this sweep)")
    return kernel_record(
        "power_sweep_carry_train", "src/repro_torch/csrc/power_sweep_carry.cu",
        "src/repro/kernels/power_sweep/kernel.py:363", err_mu, ms, plain_ms,
        bound, bound_by,
        also_replaces="src/repro/kernels/power_sweep/kernel.py:523")


def check_scatter(ops, gen, *, W, K, P, Pk, dup_zero_rows, timed):
    """The row scatter at distinct rows and topics (as top-k selects them),
    exactly; ``dup_zero_rows`` trailing slots repeat one row with zero
    values.  Timed, the kernel and its library call in turns, 15 each,
    with the L2 flushed and warm (flushed, then ``pack_rows`` of the same
    selection outside the timed region, as the iteration's pack or sweep
    reads the same sectors on the main path): the kernel's flushed median
    may not exceed the library's."""
    import torch

    dev = "cuda"
    mat = torch.rand((W, K), generator=gen, device=dev) * 4
    sel_w = torch.randperm(W, generator=gen, device=dev)[:P].to(torch.int32)
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    vals = torch.randn((P, Pk), generator=gen, device=dev)
    if dup_zero_rows:
        sel_w[-dup_zero_rows:] = sel_w[-dup_zero_rows - 1]
        vals[-dup_zero_rows - 1:] = 0.0
    want = ops.scatter_add_rows_plain(mat.clone(), sel_w, sel_k, vals)
    got = ops.scatter_add_rows(mat.clone(), sel_w, sel_k, vals)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[kernel] scatter_add_rows W={W} K={K} P={P} Pk={Pk}: "
          f"max|dmat|={err:.3e} (exact)")
    if not err == 0.0:
        fail(f"scatter_add_rows disagrees with its plain version at W={W} "
             f"K={K} P={P}")
    if not timed:
        return None
    del want, got
    args = lambda: (mat, sel_w, sel_k, vals)          # noqa: E731
    rows = sel_w.long()[:, None].expand(-1, Pk)
    cols = sel_k.long()
    fns = {"kernel": (ops.scatter_add_rows, args),
           "library": (lambda m, w, k, v: m.index_put_((rows, cols), v,
                                                       accumulate=True),
                       args)}
    flushed = time_turns(fns, 15)
    warm = time_turns(fns, 15, warm=lambda: ops.pack_rows(mat, sel_w, sel_k))
    ms, library_ms = flushed["kernel"], flushed["library"]
    plain_ms = time_ms(ops.scatter_add_rows_plain, args)
    bound, bound_by = bound_ms(4 * (P + 4 * P * Pk), P * Pk)
    # not a bound: the distinct 32-byte sectors the pairs touch, each read
    # and written back
    sectors = int(torch.unique((rows * K + cols) // 8).numel())
    print(f"[kernel] scatter_add_rows: {ms:.4f} ms flushed, "
          f"{warm['kernel']:.4f} ms warm  plain {plain_ms:.4f} ms  bound "
          f"{bound * 1e3:.2f} us ({bound_by})  library (index_put_, "
          f"accumulate) {library_ms:.4f} ms flushed, {warm['library']:.4f} ms"
          f" warm (medians of 15 in turns; gate: kernel <= library, flushed)"
          f"  {sectors} sectors ({sectors / P:.1f} a row): "
          f"{sectors / ms / 1e6:.2f} G sectors/s flushed")
    if not ms <= library_ms:
        fail(f"scatter_add_rows ({ms:.4f} ms) is slower than its library "
             f"call ({library_ms:.4f} ms)")
    return kernel_record("scatter_add_rows", "src/repro_torch/csrc/power_pack.cu",
                         "src/repro/kernels/power_pack/kernel.py:75", err, ms,
                         plain_ms, bound, bound_by, library_ms,
                         ms_warm=warm["kernel"],
                         library_ms_warm=warm["library"])


def det_index_add(word_ids, values, W):
    """``index_add_`` of ``values`` rows into a new [W, K] matrix with
    PyTorch's deterministic algorithms on for this call only (its
    deterministic path, a sorted ``index_put_`` with accumulate)."""
    import torch

    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return torch.zeros((W, values.shape[1]), device=values.device
                           ).index_add_(0, word_ids, values)
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn)


def check_word_rows_sum(seg, gen, *, D, L, K, W, timed):
    """The word scatter (``token_scatter_wk``'s kernel) on Zipf-like words,
    each at most once a document as in a padded batch, with count-0
    padding slots on word 0 (values c * mu): bit for bit against its
    plain version on the CPU (both add each word's tokens in token order),
    and repeating bit for bit.  Timed in turns (15) with the two routes of
    the same function in PyTorch: ``index_add_`` with the deterministic
    algorithms on for the call (its library time) and plain
    ``index_add_``, whose atomics do not repeat."""
    import torch

    from repro_torch.core.types import token_runs

    dev = "cuda"
    T = D * L
    _, counts = doc_tokens(gen, D=D, L=L, ragged=True)
    zipf = 1.0 / torch.arange(1, W + 1, device=dev, dtype=torch.float32)
    words = torch.multinomial(zipf.expand(D, W), min(L, W), generator=gen)
    words = torch.nn.functional.pad(words, (0, L - words.shape[1])
                                    ).reshape(-1)
    words = torch.where(counts[:, 0] > 0, words, 0).to(torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev)
    values = (counts * mu).contiguous()
    del mu
    runs = token_runs(words, counts, W)
    got = seg.word_rows_sum(*runs, values, W)
    again = seg.word_rows_sum(*runs, values, W)
    want = seg.word_rows_sum_plain(*[r.cpu() for r in runs], values.cpu(), W)
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max())
    same = bool(torch.equal(got, again))
    del got, again, want
    print(f"[kernel] word_rows_sum T={T} K={K} W={W}: max|dout|={err:.3e} "
          f"against the CPU (exact)  relaunch bit for bit: {same}")
    if not (err == 0.0 and same):
        fail(f"word_rows_sum disagrees with its plain version or does not "
             f"repeat at T={T} K={K} W={W}")
    if not timed:
        return None
    wl = words.long()
    args = lambda: (*runs, values, W)                 # noqa: E731
    lib_args = lambda: (wl, values, W)                # noqa: E731
    turns = time_turns({
        "kernel": (seg.word_rows_sum, args),
        "deterministic": (det_index_add, lib_args),
        "index_add": (lambda w, v, n: torch.zeros(
            (n, K), device=dev).index_add_(0, w, v), lib_args)}, 15)
    plain_ms = time_ms(seg.word_rows_sum_plain, args)
    d1, d2 = det_index_add(wl, values, W), det_index_add(wl, values, W)
    det_same = bool(torch.equal(d1, d2))
    del d1, d2
    n_c = int((counts > 0).sum())
    bound, bound_by = bound_ms(4 * (n_c * K + W * K + n_c + W + 1), n_c * K)
    ms, library_ms = turns["kernel"], turns["deterministic"]
    print(f"[kernel] word_rows_sum: {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {bound:.4f} ms ({bound_by}; {n_c} counted tokens)  library "
          f"(index_add_, deterministic algorithms on) {library_ms:.4f} ms "
          f"(repeats bit for bit: {det_same})  index_add_ (atomics) "
          f"{turns['index_add']:.4f} ms  (medians of 15 in turns)")
    return kernel_record(
        "word_rows_sum", "src/repro_torch/csrc/segment_sum.cu",
        "none (added by the port): the scatter-add of "
        "src/repro/core/residuals.py:12 (token_scatter_wk)", err, ms,
        plain_ms, bound, bound_by, library_ms,
        index_add_ms=turns["index_add"])


def check_topic_sum(seg, gen, *, P, Pk, K, timed):
    """The phi_tot refresh's per-topic sum against a float64 sum on the
    CPU (relative 1e-5 of the sums' scale: the kernel adds in blocks) and
    repeating bit for bit; timed with its plain version and one library
    call (``index_add_`` of the pairs into [K])."""
    import torch

    dev = "cuda"
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    vals = torch.randn((P, Pk), generator=gen, device=dev)
    base = torch.rand(K, generator=gen, device=dev) * 1e3
    got = seg.topic_sum(sel_k, vals, base)
    again = seg.topic_sum(sel_k, vals, base)
    want = base.double().cpu().index_add(
        0, sel_k.reshape(-1).long().cpu(), vals.reshape(-1).double().cpu())
    scale = float(base.abs().max()) + float(
        torch.zeros(K, dtype=torch.float64).index_add(
            0, sel_k.reshape(-1).long().cpu(),
            vals.reshape(-1).abs().double().cpu()).max())
    err = float((got.cpu().double() - want).abs().max())
    same = bool(torch.equal(got, again))
    print(f"[kernel] topic_sum P={P} Pk={Pk} K={K}: max|dout|={err:.3e} "
          f"(tol 1e-5 x {scale:.3e})  relaunch bit for bit: {same}")
    if not (err <= 1e-5 * scale and same):
        fail(f"topic_sum disagrees with its plain version or does not "
             f"repeat at P={P} Pk={Pk} K={K}")
    if not timed:
        return None
    flat_k, flat_v = sel_k.reshape(-1).long(), vals.reshape(-1)
    args = lambda: (sel_k, vals, base)                # noqa: E731
    ms = time_ms(seg.topic_sum, args)
    plain_ms = time_ms(seg.topic_sum_plain, args)
    library_ms = time_ms(lambda k, v: torch.zeros(K, device=dev).index_add_(
        0, k, v), lambda: (flat_k, flat_v))
    bound, bound_by = bound_ms(4 * (2 * P * Pk + 2 * K), P * Pk)
    print(f"[kernel] topic_sum: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"{bound * 1e3:.2f} us ({bound_by})  library (index_add_ into [K]) "
          f"{library_ms:.4f} ms")
    return kernel_record(
        "topic_sum", "src/repro_torch/csrc/segment_sum.cu",
        "none (added by the port): the scatter-add "
        "src/repro/core/pobp.py:620 (phi_tot.at[sel_k].add)", err, ms,
        plain_ms, bound, bound_by, library_ms)


def packed_inputs(gen, *, D, L, K, P, Pk, guard_share, empty_doc,
                  skewed=False):
    """Inputs of one packed sweep: doc-contiguous tokens with a ragged last
    document, a ``guard_share`` of them on the guard id P (and, with
    ``empty_doc``, all of document 0, whose counts are 0), each power row's
    Pk distinct topics, phi_pack above each token's own count.  Rows are
    uniform, or with ``skewed`` drawn Zipf-like (weight 1 / rank) with each
    document's padding slots (a random quarter to all of its length, count
    0) on row 0, the padding word's row: one very long row, as the main
    path has when word 0 is a power word."""
    import torch

    dev = "cuda"
    T = D * L
    doc_ids, counts = doc_tokens(gen, D=D, L=L, ragged=True)
    pad = torch.zeros(T, dtype=torch.bool, device=dev)
    if skewed:
        zipf = 1.0 / torch.arange(1, P + 1, device=dev, dtype=torch.float32)
        p_tok = torch.multinomial(zipf, T, replacement=True, generator=gen)
        lens = torch.randint(L // 4, L + 1, (D,), generator=gen, device=dev)
        pad = (torch.arange(L, device=dev).repeat(D)
               >= lens.repeat_interleave(L))
        p_tok[pad] = 0
        counts[pad] = 0.0
    else:
        p_tok = torch.randint(0, P, (T,), generator=gen, device=dev)
    guard = (torch.rand(T, generator=gen, device=dev) < guard_share) & ~pad
    if empty_doc:
        guard |= doc_ids == 0
        counts[doc_ids == 0] = 0.0
    p_tok = torch.where(guard, P, p_tok).to(torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev) + 0.01
    mu /= mu.sum(1, keepdim=True)
    theta = torch.zeros((D, K), device=dev).index_add_(0, doc_ids.long(),
                                                       counts * mu)
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    phi_pack = torch.rand((P, Pk), generator=gen, device=dev) * 5 + 3
    phi_tot = torch.rand(K, generator=gen, device=dev) * 50 + 30
    return [p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k]


def selected_mask(mu, p_tok, sel_k, P):
    """True at each power token's selected topics: what a sweep may change."""
    import torch

    sel = torch.zeros_like(mu, dtype=torch.bool)
    rows = (p_tok < P).nonzero().squeeze(1)
    sel[rows[:, None], sel_k.long()[p_tok.long()[rows]]] = True
    return sel


def check_packed_sweep(packed, gen, *, D, L, K, P, Pk, guard_share,
                       empty_doc, timed, skewed=False):
    """The packed sweep against its plain version: mu', theta_delta, d_pack
    and r_pack at rel 1e-5 (max |gap| over max |plain|); every coordinate
    outside the power tokens' selections bit for bit as it was; a second
    launch on the same inputs repeats all four outputs bit for bit.  The
    kernel gets its sweep order made beforehand, as the training step makes
    it once per mini-batch."""
    import torch

    from repro_torch.core.types import sweep_order

    x = packed_inputs(gen, D=D, L=L, K=K, P=P, Pk=Pk,
                      guard_share=guard_share, empty_doc=empty_doc,
                      skewed=skewed)
    kw = dict(alpha=0.1, beta=0.01, wbeta=141043 * 0.01)
    order = sweep_order(torch.where(x[0] < P, x[0], P), x[2])

    def fresh():
        a = list(x)
        a[3] = x[3].clone()
        return a

    got = packed.power_sweep_tokens(*fresh(), **kw, order=order)
    again = packed.power_sweep_tokens(*fresh(), **kw, order=order)
    want = packed.power_sweep_tokens_plain(*fresh(), **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel = [rel_err(g, w) for g, w in zip(got, want)]
    off = ~selected_mask(x[3], x[0], x[7], P)
    kept = bool(torch.equal(got[0][off], x[3][off]))
    same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
    tag = " skewed" if skewed else ""
    print(f"[kernel] power_sweep_tokens{tag} T={D * L} D={D} K={K} P={P} "
          f"Pk={Pk} guard={guard_share}: rel mu'={rel[0]:.3e}  rel dtheta="
          f"{rel[1]:.3e}  rel d_pack={rel[2]:.3e}  rel r_pack={rel[3]:.3e} "
          f"(tol 1e-5)  untouched bit for bit: {kept}  relaunch bit for bit: "
          f"{same}")
    if not (max(rel) <= 1e-5 and kept and same):
        fail(f"power_sweep_tokens disagrees with its plain version or "
             f"itself at D={D} L={L} K={K} P={P} Pk={Pk}")
    if not timed:
        return None
    del got, again, want
    ms = time_ms(lambda *a: packed.power_sweep_tokens(*a, **kw, order=order),
                 fresh)
    plain_ms = time_ms(lambda *a: packed.power_sweep_tokens_plain(*a, **kw),
                       fresh)
    # what the sweep must move: each power token's mu at its Pk topics, read
    # and written; theta at the distinct (document, topic) pairs selected;
    # sel_k and phi_pack of each power word present; the theta delta and
    # the packed d/r buffers written once; the per-token ids and counts;
    # phi_tot
    T = D * L
    p, doc = x[0], x[1]
    act = p < P
    n_act = int(act.sum())
    n_rows = int(torch.unique(p[act]).numel())
    pairs = doc[act].long()[:, None] * K + x[7].long()[p[act].long()]
    n_dk = int(torch.unique(pairs).numel())
    nbytes = 4 * (2 * n_rows * Pk + 2 * n_act * Pk + n_dk + D * K
                  + 2 * P * Pk + 3 * T + K)
    bound, bound_by = bound_ms(nbytes, 30 * n_act * Pk)
    # not a bound: each (token, topic) element of the [T, K] mu is a
    # 32-byte sector of its own, read and written
    floor = 2 * n_act * Pk * 32 / HBM_BYTES_PER_S * 1e3
    runs = torch.bincount(p[act & (x[2][:, 0] != 0)].long(), minlength=P)
    print(f"[kernel] power_sweep_tokens{tag}: {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {bound * 1e3:.2f} us ({bound_by})  "
          f"sector floor {floor * 1e3:.2f} us  longest row {int(runs.max())} "
          f"counted tokens  library: none (no single PyTorch call computes "
          f"this sweep)")
    return kernel_record(
        "power_sweep_tokens", "src/repro_torch/csrc/power_sweep_tokens.cu",
        "src/repro/kernels/power_sweep/kernel.py:174", err_mu, ms, plain_ms,
        bound, bound_by)


def check_pack_rows(pack_ops, gen, *, W, K, P, Pk, outside, timed):
    """The phi pack against its plain version, exactly; with ``outside``,
    a column and a row outside the matrix pack to 0."""
    import torch

    dev = "cuda"
    mat = torch.rand((W, K), generator=gen, device=dev) * 4
    sel_w = torch.randperm(W, generator=gen, device=dev)[:P].to(torch.int32)
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    if outside:
        sel_k[0, 0] = K
        sel_w[1] = W
    got = pack_ops.pack_rows(mat, sel_w, sel_k)
    want = pack_ops.pack_rows_plain(mat, sel_w, sel_k)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    zeros = not outside or (float(got[0, 0]) == 0.0
                            and not bool(got[1].any()))
    print(f"[kernel] pack_rows W={W} K={K} P={P} Pk={Pk}: max|dout|="
          f"{err:.3e} (exact)" + ("  outside pairs 0: " + str(zeros)
                                  if outside else ""))
    if not (err == 0.0 and zeros):
        fail(f"pack_rows disagrees with its plain version at W={W} K={K} "
             f"P={P} Pk={Pk}")
    if not timed:
        return None
    args = lambda: (mat, sel_w, sel_k)                # noqa: E731
    rows, cols = sel_w.long()[:, None], sel_k.long()
    # kernel and library in turns, 15 timings each: the kernel's median may
    # not exceed the library's
    med = time_turns({"kernel": (pack_ops.pack_rows, args),
                      "library": (lambda m, w, k: m[rows, cols], args)}, 15)
    ms, library_ms = med["kernel"], med["library"]
    plain_ms = time_ms(pack_ops.pack_rows_plain, args)
    bound, bound_by = bound_ms(4 * (P + 3 * P * Pk), 0)
    print(f"[kernel] pack_rows: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"{bound * 1e3:.2f} us ({bound_by})  library (mat[sel_w[:, None], "
          f"sel_k]) {library_ms:.4f} ms (medians of 15 in turns; gate: "
          f"kernel <= library)")
    if not ms <= library_ms:
        fail(f"pack_rows ({ms:.4f} ms) is slower than its library call "
             f"({library_ms:.4f} ms)")
    return kernel_record("pack_rows", "src/repro_torch/csrc/power_pack.cu",
                         "src/repro/kernels/power_pack/kernel.py:50", err, ms,
                         plain_ms, bound, bound_by, library_ms)


# --------------------------------------------------------------- phase 3

def model_on_device(gen, W: int, K: int, device):
    """A topic model made on the device from ``gen``: topics
    phi_true[K, W] ~ Dirichlet(0.06), as ``data.synthetic.lda_corpus``
    draws them, and the trained statistic phi_acc[W, K] = phi_true.T * 2e5
    (about 1.4 tokens per cell, so beta = 0.01 is a small prior beside it,
    as in a trained model)."""
    import torch

    conc = torch.full((K, W), 0.06, device=device)
    phi_true = torch._standard_gamma(conc, generator=gen)
    del conc
    phi_true /= phi_true.sum(dim=1, keepdim=True)
    return phi_true, (phi_true.T * 2e5).contiguous()


def sample_docs(gen, phi_true, n_docs: int, len_means, alpha: float = 0.1):
    """``n_docs`` documents from the LDA generative model on the device:
    lengths max(4, Poisson(mean)) with the means taken in turn, theta ~
    Dirichlet(alpha + 0.05), topics z ~ theta, words ~ phi_true[z].
    Returns (word_ids int32, counts float32) numpy pairs."""
    import numpy as np
    import torch

    K, W = phi_true.shape
    dev = phi_true.device
    means = torch.tensor([len_means[i % len(len_means)]
                          for i in range(n_docs)], dtype=torch.float32,
                         device=dev)
    lens = torch.poisson(means, generator=gen).clamp_min(4).long()
    theta = torch._standard_gamma(
        torch.full((n_docs, K), alpha + 0.05, device=dev), generator=gen)
    theta /= theta.sum(dim=1, keepdim=True)
    z = torch.multinomial(theta, int(lens.max()), replacement=True,
                          generator=gen)
    keep = torch.arange(z.shape[1], device=dev)[None, :] < lens[:, None]
    zk = z[keep]
    words = torch.empty_like(zk)
    for k in torch.unique(zk).tolist():
        idx = (zk == k).nonzero(as_tuple=True)[0]
        words[idx] = torch.multinomial(phi_true[k], idx.numel(),
                                       replacement=True, generator=gen)
    words = words.cpu().numpy()
    ends = np.cumsum(lens.cpu().numpy())
    docs = []
    for toks in np.split(words, ends[:-1]):
        ids, cnt = np.unique(toks, return_counts=True)
        docs.append((ids.astype(np.int32), cnt.astype(np.float32)))
    return docs


def serve_slice(*, W: int, K: int, requests: int, seed: int, device,
                ckpt_dir: Path, slots: int = 64, slot_len: int = 64,
                sweeps_per_step: int = 4, fold_iters: int = 30,
                tol: float = 1e-2, len_means=(12, 24, 40)):
    """Checkpoint -> ``SlabEngine.from_checkpoint`` -> ``requests``
    closed-loop requests, with the checks of the serving contract.  Returns
    (engine, docs, results, wall_s, kernel launches, engine stats)."""
    import numpy as np
    import torch

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import SlabEngine

    gen = torch.Generator(device=device).manual_seed(seed)
    phi_true, phi_acc = model_on_device(gen, W, K, device)
    docs = sample_docs(gen, phi_true, requests, len_means)
    del phi_true
    ckpt.save(str(ckpt_dir), 1, {"state": {"phi_acc": phi_acc}},
              extra={"run": {"vocab": W, "topics": K}})
    del phi_acc
    engine = SlabEngine.from_checkpoint(
        str(ckpt_dir), slots=slots, slot_len=slot_len,
        sweeps_per_step=sweeps_per_step, fold_iters=fold_iters,
        residual_tol=tol, seed=seed, device=device)
    if engine.cfg.vocab_size != W or engine.cfg.num_topics != K:
        fail(f"served geometry {engine.cfg.vocab_size}x"
             f"{engine.cfg.num_topics} != {W}x{K}")

    launch_counts(reset=True)                    # the main path starts here
    results, wall = serve_burst(engine, docs)
    launches = launch_counts()["power_sweep_carry"]   # ... and ends here

    stats = engine.stats()
    theta = np.stack([r.theta for r in results])
    if theta.shape != (requests, K) or not np.isfinite(theta).all():
        fail("served thetas are not finite [requests, K]")
    err = float(np.abs(theta.sum(axis=1) - 1.0).max())
    if err > 1e-5 or any(r.error for r in results):
        fail(f"served thetas do not sum to 1 (max |sum - 1| = {err:.2e})")
    return engine, docs, results, wall, launches, stats


def burst_reading(engine, results, wall: float):
    """One closed-loop burst's (docs/s, p50 s, p99 s, step_ema s)."""
    import numpy as np

    lat = np.array([r.latency_s for r in results])
    return (len(results) / wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)), engine.stats()["step_ema_s"])


def serve_burst(engine, docs):
    """Submit every document, drain, and check every one came back."""
    t0 = time.time()
    ids = [engine.submit(d) for d in docs]
    results = engine.drain()
    wall = time.time() - t0
    if sorted(r.req_id for r in results) != sorted(ids):
        fail(f"{len(results)} of {len(ids)} requests came back")
    return results, wall


# --------------------------------------------------------------- phase 5

def profile_serve(engine, docs, card: str) -> None:
    """Serve ``docs`` once more under ``torch.profiler``."""
    def serve():
        for d in docs:
            engine.submit(d)
        engine.drain()

    profile_run(serve, f"{len(docs)} requests", card)


# --------------------------------------------------------------- phase 6

def padded_batches(gen, phi_true, *, D, L, len_means):
    """One [D, L] mini-batch per length mean, sampled from the model."""
    from repro_torch.data.batching import docs_to_padded

    return [docs_to_padded(sample_docs(gen, phi_true, D, (mean,)),
                           max_len=L) for mean in len_means]


def heldout_split(gen, phi_true, *, n_docs, mean, seed):
    """Held-out documents from the model, split 80/20 by token."""
    from repro_torch.data.batching import (docs_to_padded,
                                           train_test_split_counts)

    train, test = train_test_split_counts(
        sample_docs(gen, phi_true, n_docs, (mean,)), seed)
    return docs_to_padded(train), docs_to_padded(test)


def train_kernels():
    from repro_torch.core import pobp, power, residuals
    from repro_torch.kernels.bp_update import ops as bp_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops as sweep_ops
    from repro_torch.kernels.segment_sum import ops as seg_ops

    return {"bp_update": (bp_ops.bp_update, pobp, "bp_update",
                          bp_ops.bp_update_plain),
            "power_sweep_carry_train": (
                sweep_ops.power_sweep_carry_train, pobp,
                "power_sweep_carry_train",
                sweep_ops.power_sweep_carry_train_plain),
            "scatter_add_rows": (pack_ops.scatter_add_rows, power,
                                 "_scatter_add",
                                 pack_ops.scatter_add_rows_plain),
            "word_rows_sum": (seg_ops.word_rows_sum, residuals,
                              "word_rows_sum", seg_ops.word_rows_sum_plain),
            "topic_sum": (seg_ops.topic_sum, pobp, "topic_sum",
                          seg_ops.topic_sum_plain)}


def train_data(*, W: int, K: int, D: int, L: int, steps: int, seed: int,
               device, len_means=(64, 128, 192)):
    """The training slice's data, sampled on the device from a model drawn
    from ``seed``: ``steps`` [D, L] mini-batches and a held-out split."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    phi_true, _ = model_on_device(gen, W, K, device)
    means = [len_means[i % len(len_means)] for i in range(steps)]
    batches = padded_batches(gen, phi_true, D=D, L=L, len_means=means)
    heldout = heldout_split(gen, phi_true, n_docs=256, mean=128, seed=seed)
    return batches, heldout


def train_slice(batches, *, W: int, K: int, seed: int, device,
                sweep_policy: str = "auto", inner_iters: int = 200,
                tol: float = 0.1, card: str = ""):
    """One POBP step per mini-batch of ``batches`` at (W, K) with
    ``sweep_policy``, with checks (a)-(c) of the training contract: the
    kernels of that policy launched as often as its steps and selective
    iterations (the other policy's never), phi_acc holding every token
    consumed, finite and non-negative.  Returns (cfg, state, step, launch
    counts, readings)."""
    import torch

    from repro_torch.core.pobp import init_train_state, make_train_step
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import launch_counts

    tag = "packed" if sweep_policy == "packed" else "train"
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_w=0.1,
                    lambda_k_abs=50, inner_iters=inner_iters,
                    residual_tol=tol, sweep_policy=sweep_policy)
    step, _ = make_train_step(cfg, device=device)
    state = init_train_state(cfg, seed, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    readings, tokens = [], 0.0
    sync()
    launch_counts(reset=True)                    # the main path starts here
    for mb in batches:
        t0 = time.time()
        state, diag = step(state, mb.word_ids, mb.counts)
        mean_r = float(diag["mean_r"])
        sync()
        wall = time.time() - t0
        ntok = float(mb.counts.sum())
        tokens += ntok
        readings.append((wall, diag["iters"], ntok, mean_r))
    launches = launch_counts()                   # ... and ends here

    for i, (wall, iters, ntok, mean_r) in enumerate(readings):
        print(f"[{tag}] step {i + 1}: {wall * 1e3:.3f} ms  iters={iters}  "
              f"{wall * 1e3 / iters:.3f} ms/iteration  "
              f"{ntok / wall:.1f} tokens/s  mean_r={mean_r:.4f}  "
              f"({ntok:.0f} tokens) [{card}]")
    sweeps = sum(iters - 1 for _, iters, _, _ in readings)
    packed = sweep_policy == "packed"
    want = {"bp_update": len(batches), "power_sweep_carry": 0,
            "power_sweep_carry_train": 0 if packed else sweeps,
            "scatter_add_rows": sweeps,
            "power_sweep_tokens": sweeps if packed else 0,
            "pack_rows": sweeps if packed else 0,
            "word_rows_sum": 3 * len(batches),
            "topic_sum": sweeps}
    print(f"[{tag}] launches {launches} (steps={len(batches)}, selective "
          f"sweeps={sweeps}, sweep_policy={sweep_policy})")
    if launches != want or readings[0][1] < 2:
        fail(f"training kernels launched {launches}, expected {want} with "
             f"the first step past its dense sweep")
    mass = float(state.phi_acc.sum(dtype=torch.float64))
    print(f"[{tag}] phi_acc mass {mass:.3f} against {tokens:.0f} tokens "
          f"consumed (rel {abs(mass - tokens) / tokens:.2e}, tol 1e-4)")
    if not abs(mass - tokens) <= 1e-4 * tokens:
        fail("phi_acc does not hold the tokens consumed")
    lo = float(state.phi_acc.min())
    if not (bool(torch.isfinite(state.phi_acc).all()) and lo >= -1e-3):
        fail(f"phi_acc is not finite and non-negative (min {lo:.3e})")
    return cfg, state, step, launches, readings


def repeat_step(step, state, mb, tag: str, card: str) -> None:
    """One mini-batch run twice from one state, the generator's state put
    back in between: phi_acc, theta, mean_r and iterations must be equal
    bit for bit (every sum of the step runs in a fixed order)."""
    import torch

    rng = state.generator.get_state()
    runs = []
    for _ in range(2):
        state.generator.set_state(rng)
        torch.cuda.synchronize()
        t0 = time.time()
        new, diag = step(state, mb.word_ids, mb.counts)
        mean_r = float(diag["mean_r"])
        torch.cuda.synchronize()
        runs.append((new.phi_acc, diag["theta"], mean_r, diag["iters"],
                     (time.time() - t0) * 1e3))
        del new, diag
    (pa, ta, ra, ia, wa), (pb, tb, rb, ib, wb) = runs
    same = {"phi_acc": bool(torch.equal(pa, pb)),
            "theta": bool(torch.equal(ta, tb)), "mean_r": ra == rb,
            "iters": ia == ib}
    print(f"[{tag}] one mini-batch twice from one state (m={state.m}): "
          f"bit for bit {same}  mean_r {ra!r} / {rb!r}  iters {ia}/{ib}  "
          f"{wa:.3f} / {wb:.3f} ms  [{card}]")
    if not all(same.values()):
        fail(f"{tag}: a mini-batch run twice from one state differs")


def packed_vs_carry(mb, u0, *, W, K, seed, device="cuda", inner_iters=8,
                    order=("auto", "packed", "packed", "auto")):
    """One mini-batch ``mb`` from one injected init ``u0`` through the
    carry (``auto``) and packed policies in the turns of ``order``, with
    tolerance 0 and ``inner_iters`` iterations each.  Returns the relative
    L1 gaps of phi_acc and theta between the first run of each policy, and
    each run's (policy, wall ms, iterations)."""
    import torch

    from repro_torch.core.pobp import init_train_state, make_train_step
    from repro_torch.core.types import LDAConfig

    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    first, runs = {}, []
    for policy in order:
        cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_w=0.1,
                        lambda_k_abs=50, inner_iters=inner_iters,
                        residual_tol=0.0, sweep_policy=policy)
        step, _ = make_train_step(cfg, device=device)
        state = init_train_state(cfg, seed, device=device)
        sync()
        t0 = time.time()
        state, diag = step(state, mb.word_ids, mb.counts, u0=u0)
        sync()
        runs.append((policy, (time.time() - t0) * 1e3, diag["iters"]))
        first.setdefault(policy, (state.phi_acc, diag["theta"]))
        del state, diag
    (phi_c, th_c), (phi_p, th_p) = first["auto"], first["packed"]
    gap = {name: float((p - c).abs().sum() / c.abs().sum())
           for name, p, c in (("phi_acc", phi_p, phi_c),
                              ("theta", th_p, th_c))}
    return gap, runs


def train_kernel_vs_plain(*, seed: int, W=20000, K=256, D=64, L=64,
                          inner_iters=8, device="cuda"):
    """Check (d): one mini-batch from one injected init through the
    training kernels and through their plain versions.  phi_acc and theta
    of the step must agree to a relative L1 gap of 1e-4 (the plain
    versions add in other orders); iterations and held-out perplexity are
    printed."""
    from unittest import mock

    import torch

    from repro_torch.core.perplexity import evaluate
    from repro_torch.core.pobp import init_train_state, make_train_step
    from repro_torch.core.types import LDAConfig

    gen = torch.Generator(device=device).manual_seed(seed + 7)
    phi_true, _ = model_on_device(gen, W, K, device)
    (mb,) = padded_batches(gen, phi_true, D=D, L=L, len_means=(64,))
    train, test = heldout_split(gen, phi_true, n_docs=64, mean=64,
                                seed=seed)
    u0 = torch.rand((D, L, K), generator=gen, device=device) * 0.99 + 0.01
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_w=0.1,
                    lambda_k_abs=50, inner_iters=inner_iters,
                    residual_tol=0.0)
    out = {}
    for mode in ("kernel", "plain"):
        patches = [] if mode == "kernel" else [
            mock.patch.object(module, attr, plain)
            for _, module, attr, plain in train_kernels().values()]
        for pt in patches:
            pt.start()
        try:
            step, _ = make_train_step(cfg, device=device)
            state, diag = step(init_train_state(cfg, seed, device=device),
                               mb.word_ids, mb.counts, u0=u0)
        finally:
            for pt in patches:
                pt.stop()
        ppl = evaluate(state.phi_acc, train, test, cfg,
                       generator=torch.Generator(device=device
                                                 ).manual_seed(seed + 1),
                       device=device)
        out[mode] = (diag["iters"], ppl, state.phi_acc, diag["theta"])
    (it_k, ppl_k, phi_k, th_k), (it_p, ppl_p, phi_p, th_p) = \
        out["kernel"], out["plain"]
    gap = {name: float((k - p).abs().sum() / p.abs().sum())
           for name, k, p in (("phi_acc", phi_k, phi_p),
                              ("theta", th_k, th_p))}
    print(f"[train] kernels vs plain at W={W} K={K} D={D} L={L}: rel L1 gap "
          f"phi_acc {gap['phi_acc']:.3e}, theta {gap['theta']:.3e} (tol "
          f"1e-4)  iters {it_k}/{it_p}  held-out ppl {ppl_k:.4f}/{ppl_p:.4f}")
    if not max(gap.values()) <= 1e-4:
        fail("the training step through the kernels disagrees with its plain "
             "version")


def decay_meter_check(*, seed: int, W=20000, K=256, D=64, L=64,
                      device="cuda"):
    """One training step with the Robbins-Monro decay on (decay_kappa 0.5)
    at a reduced shape: the step's byte meter must bill the decay's [W, K]
    pass once, W * K * 4 bytes under ``decay``, and nothing else (one
    shard)."""
    import torch

    from repro_torch.core.pobp import init_train_state, make_train_step
    from repro_torch.core.types import LDAConfig

    gen = torch.Generator(device=device).manual_seed(seed + 13)
    phi_true, _ = model_on_device(gen, W, K, device)
    (mb,) = padded_batches(gen, phi_true, D=D, L=L, len_means=(64,))
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_w=0.1,
                    lambda_k_abs=50, inner_iters=8, residual_tol=0.1,
                    decay_kappa=0.5)
    step, meter = make_train_step(cfg, device=device)
    state, diag = step(init_train_state(cfg, seed, device=device),
                       mb.word_ids, mb.counts)
    by = meter.bytes_by_phase
    per = meter.per_minibatch_bytes(diag["iters"])
    print(f"[train] decay_kappa=0.5 at W={W} K={K}: meter {by}, "
          f"per-minibatch {per:,} bytes (want decay = W*K*4 = {W * K * 4:,})"
          f"  iters {diag['iters']}")
    if by != {"decay": W * K * 4} or per != W * K * 4:
        fail("the decay pass is not billed once per mini-batch")


# --------------------------------------------------------------- phase 8

DRIVER_KERNELS = ("bp_update", "power_sweep_carry_train", "scatter_add_rows",
                  "word_rows_sum", "topic_sum")


def driver_args(ckpt_dir, *, seed: int, docs: int, extra=()):
    """The driver's flags at PUBMED width with the paper-scale settings:
    4 mini-batches of ``docs`` documents (length mean 128, one bucket of
    128), a checkpoint every 2."""
    from repro_torch.launch import lda_train

    return lda_train.build_parser().parse_args([
        "--vocab", "141043", "--topics", "2000", "--lambda-w", "0.1",
        "--lambda-k", "50", "--inner-iters", "200", "--tol", "0.1",
        "--docs-per-batch", str(docs), "--doc-len-means", "128",
        "--len-buckets", "128", "--minibatches", "4", "--ckpt-every", "2",
        "--log-every", "0", "--seed", str(seed), "--device", "cuda",
        "--ckpt-dir", str(ckpt_dir), *extra])


def timed_driver(args, walls: list, io: dict):
    """``lda_train.train_loop(args)`` with each step of the run's stream
    timed (host clock, ended by a device sync; the first step built is the
    run's, and its last calls are the stream's) and the checkpoint saves
    and restores timed into ``io`` (seconds)."""
    from unittest import mock

    import torch

    from repro_torch.core import pobp
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import lda_train

    make, save, restore = (pobp.make_train_step, ckpt.save,
                           ckpt.restore_latest)
    built = []

    def make_timed(*a, **kw):
        step, meter = make(*a, **kw)
        if built:
            return step, meter
        built.append(step)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = step(*sa, **skw)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            return out
        return timed, meter

    def clocked(fn, key):
        def run(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            io.setdefault(key, []).append(time.time() - t0)
            return out
        return run

    with mock.patch.object(pobp, "make_train_step", make_timed), \
            mock.patch.object(ckpt, "save", clocked(save, "save_s")), \
            mock.patch.object(ckpt, "restore_latest",
                              clocked(restore, "restore_s")):
        return lda_train.train_loop(args)


def driver_slice(*, seed: int, docs: int, card: str):
    """Phase 8: the training driver on the card at PUBMED width.  (a) four
    mini-batches, a checkpoint every 2; (b) the same in a fresh directory
    with ``--crash-at 3``, which must end by SystemExit; (c) the same
    command again: it must resume at m = 2 and end with (a)'s mean_r,
    iterations and phi_acc bit for bit; (d) (a) with ``--phi-acc-dtype
    bfloat16``: its stored phi_acc bf16, finite, non-negative, its mean_r
    gap to (a) printed (not gated), its peak device memory no higher than
    (a)'s, then 64 requests served in float32 from its checkpoint, each
    with a finite theta summing to 1 +- 1e-5; (e) (a) with ``--prefetch
    0``, the batches drawn between the steps: its step walls printed
    beside (a)'s, its result equal to (a)'s bit for bit.  Launch counts of
    (a) net of its warm-up: every training kernel of the path launched.
    The checkpoints live in a directory deleted at the end."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import lda_corpus_from_phi
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import lda_train
    from repro_torch.serve import SlabEngine

    root = ROOT / "build" / "chip_smoke_driver"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.time()
        a_args = driver_args(root / "a", seed=seed, docs=docs)
        phi_true, cdf = lda_train._true_phi(a_args)
        print(f"[driver] ground-truth topics (141043 x 2000 Dirichlet on "
              f"the host, and their CDFs) in {time.time() - t0:.1f}s")
        t0 = time.time()
        lda_corpus_from_phi(seed, docs, phi_true, doc_len_mean=128, cdf=cdf)
        print(f"[driver] one host draw of {docs} documents in "
              f"{time.time() - t0:.2f}s")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        walls, io = [], {}
        t0 = time.time()
        res_a = timed_driver(a_args, walls, io)
        counts = launch_counts()
        net = {k: counts[k] - res_a["warmup_launches"].get(k, 0)
               for k in counts}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = walls[-4:]
        print(f"[driver] (a) 4 mini-batches in {time.time() - t0:.1f}s "
              f"(warm-up {res_a['warmup_s']:.2f}s): mean_r "
              f"{res_a['mean_r']}  iters {res_a['iters']}  "
              f"{res_a['tokens']:.0f} tokens  peak device memory "
              f"{peak:.2f} GiB  [{card}]")
        print(f"[driver] (a) step walls (warmed): " + ", ".join(
            f"step {i + 1} {w * 1e3:.3f} ms" for i, w in enumerate(steps))
              + f"  [{card}]")
        print(f"[driver] (a) launches net of the warm-up {net}; warm-up "
              f"{res_a['warmup_launches']}")
        if any(net[k] <= 0 for k in DRIVER_KERNELS) or \
                net["power_sweep_tokens"] or net["pack_rows"]:
            fail(f"the driver's run did not go through the training kernels "
                 f"(net of its warm-up: {net})")

        b_args = driver_args(root / "b", seed=seed, docs=docs,
                             extra=("--crash-at", "3"))
        try:
            timed_driver(b_args, [], {})
        except SystemExit as e:
            print(f"[driver] (b) {e}")
        else:
            fail("--crash-at 3 did not end the run")
        res_c = timed_driver(b_args, [], io)
        same = {"first_m": res_c["first_m"] == 2,
                "mean_r": res_c["mean_r"] == res_a["mean_r"][2:],
                "iters": res_c["iters"] == res_a["iters"][2:],
                "phi_acc": bool(torch.equal(res_c["phi_acc"],
                                            res_a["phi_acc"]))}
        print(f"[driver] (c) resumed at m={res_c['first_m']}: mean_r "
              f"{res_c['mean_r']}  iters {res_c['iters']}; equal to (a) bit "
              f"for bit: {same}")
        print(f"[driver] checkpoint saves "
              f"{', '.join(f'{x:.2f}' for x in io['save_s'])} s, the "
              f"resume's restore {io['restore_s'][-1]:.2f} s (phi_acc "
              f"{res_a['phi_acc'].nbytes / 1e9:.2f} GB, verified, then "
              f"read)  [{card}]")
        if not all(same.values()):
            fail("the resumed run differs from the uninterrupted run")

        torch.cuda.reset_peak_memory_stats()
        d_args = driver_args(root / "d", seed=seed, docs=docs,
                             extra=("--phi-acc-dtype", "bfloat16"))
        res_d = timed_driver(d_args, [], {})
        peak16 = torch.cuda.max_memory_allocated() / 2**30
        phi16, _, step16 = ckpt.restore_phi(str(root / "d"))
        if not (step16 == 4 and torch.equal(phi16, res_d["phi_acc"])):
            fail("the bf16 run's last checkpoint does not hold its phi_acc")
        gaps = [abs(x - y) for x, y in zip(res_d["mean_r"], res_a["mean_r"])]
        print(f"[driver] (d) bfloat16 phi_acc (stored {phi16.dtype}): "
              f"mean_r {res_d['mean_r']}  "
              f"iters {res_d['iters']}; |mean_r - (a)| by batch "
              f"{[f'{g:.2e}' for g in gaps]} (not gated)  peak device memory "
              f"{peak16:.2f} GiB  [{card}]")
        if not (phi16.dtype == torch.bfloat16
                and bool(torch.isfinite(phi16).all())
                and float(phi16.min()) >= 0.0):
            fail(f"the bf16 run's phi_acc is not bf16, finite and "
                 f"non-negative ({phi16.dtype})")
        if peak16 > peak:
            fail(f"the bf16 run's peak device memory {peak16:.2f} GiB "
                 f"exceeds the float32 run's {peak:.2f} GiB")
        del phi16, res_d

        eng = SlabEngine.from_checkpoint(str(root / "d"), device="cuda")
        docs_ = lda_corpus_from_phi(seed + 5, 64, phi_true, doc_len_mean=40,
                                    cdf=cdf)[0]
        for doc in docs_:
            eng.submit(doc)
        out = eng.drain()
        th = np.stack([np.asarray(r.theta) for r in out])
        ok = (len(out) == 64 and bool(np.isfinite(th).all())
              and float(np.abs(th.sum(1) - 1).max()) <= 1e-5)
        print(f"[driver] (d) served {len(out)} requests in "
              f"{eng._phi.dtype} from the bf16 checkpoint: theta finite, "
              f"sums within {float(np.abs(th.sum(1) - 1).max()):.2e} of 1 "
              f"(tol 1e-5)")
        if not (ok and eng._phi.dtype == torch.float32):
            fail("serving float32 from the bf16 checkpoint failed")
        del eng

        e_walls = []
        res_e = timed_driver(driver_args(root / "e", seed=seed, docs=docs,
                                         extra=("--prefetch", "0")),
                             e_walls, {})
        same = (res_e["mean_r"] == res_a["mean_r"]
                and res_e["iters"] == res_a["iters"]
                and bool(torch.equal(res_e["phi_acc"], res_a["phi_acc"])))
        print(f"[driver] (e) --prefetch 0 step walls (warmed): " + ", ".join(
            f"step {i + 1} {w * 1e3:.3f} ms" for i, w in
            enumerate(e_walls[-4:])) + f"  (against (a)'s "
              f"{', '.join(f'{w * 1e3:.3f}' for w in steps)}); equal to (a) "
              f"bit for bit: {same}  [{card}]")
        if not same:
            fail("the run without a draw thread differs from (a)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return net


def profile_run(fn, label: str, card: str, watch=()):
    """Run ``fn`` once under ``torch.profiler`` and print the card's busy
    share of the wall time (the summed time of the events that ran on the
    card: kernels, copies, fills), the top of those by device time, the
    device time and launches of the kernels whose names hold each string
    of ``watch``, and the top host operations by their own CPU time.
    Returns what ``fn`` returned and the device ms a launch of each string
    of ``watch`` that matched a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_us, dev_n, host_us = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0))
            dev_us[e.key] = dev_us.get(e.key, 0.0) + t
            dev_n[e.key] = dev_n.get(e.key, 0) + e.count
        else:
            host_us[e.key] = e.self_cpu_time_total
    if not sum(dev_us.values()):
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
        return out, {}
    busy = sum(dev_us.values()) / 1e6
    print(f"[profile] {label} in {wall * 1e3:.3f} ms wall: "
          f"device busy {busy * 1e3:.3f} ms ({busy / wall:.1%}), idle "
          f"{1 - busy / wall:.1%}  [{card}]")
    for name, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {t / 1e3:9.3f} ms  {t / 1e6 / busy:6.1%}  "
              f"{name[:90]}")
    watched = {}
    for want in watch:
        hits = [name for name in dev_us if want in name]
        if hits:
            t = sum(dev_us[name] for name in hits) / 1e3
            n = sum(dev_n[name] for name in hits)
            watched[want] = t / n
            print(f"[profile] kernel {want}: {t:.3f} ms over {n} launches = "
                  f"{t / n:.4f} ms a launch  [{card}]")
    for name, t in sorted(host_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] host {t / 1e3:9.3f} ms  {name[:80]}")
    return out, watched


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--bursts", type=int, default=9,
                    help="closed-loop bursts of the requests, the first "
                         "(counted) one included")
    ap.add_argument("--train-steps", type=int, default=3,
                    help="POBP steps of the training slices (phases 6, 7)")
    ap.add_argument("--driver-docs", type=int, default=512,
                    help="documents a mini-batch of the driver's runs "
                         "(phase 8), drawn on the host")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if shutil.which("nvidia-smi") is None:
        fail("nvidia-smi not found")

    from repro_torch.kernels import build
    from repro_torch.kernels.bp_update import ops as bp_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops, packed
    from repro_torch.kernels.segment_sum import ops as seg_ops

    # ---- 1. build
    t0 = time.time()
    libs = build.build_all(["power_sweep_carry", "bp_update", "power_pack",
                            "power_sweep_tokens", "segment_sum"])
    card = card_line()
    print(card)
    print(f"[build] {len(libs)} kernel(s) in {time.time() - t0:.1f}s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # the dense sweep's register path is sized to run without spills
    spills = [line for line in libs["bp_update"].with_suffix(".log")
              .read_text().splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    if spills:
        fail(f"bp_update spills registers: {spills}")

    # ---- 2. each kernel against its plain version
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rec = check_sweep(ops, gen, T=4096, D=64, K=2000, rows=141044,
                      frozen=0.3, empty_docs=8, timed=True)
    # odd shapes: the scalar path (K = 37, 1), K = 100, the register
    # path's limit K = 2048, and past it the K-blocked path: one past the
    # limit, K = 8192 and 8193, the reference's K = 10,000, an odd K far
    # past it
    for T, D, K in ((21, 3, 100), (21, 3, 37), (40, 5, 1), (256, 4, 2048),
                    (256, 4, 2049), (256, 4, 8192), (256, 4, 8193),
                    (256, 4, 10000), (96, 3, 20001)):
        check_sweep(ops, gen, T=T, D=D, K=K, rows=50, frozen=0.3,
                    empty_docs=1, timed=False)
    # serving at K = 10,000 at the slab's shapes (W' = 141,044 rows of phi,
    # 5.6 GB), timed with its bound and its plain version
    rec.update(check_sweep(ops, gen, T=4096, D=64, K=10000, rows=141044,
                           frozen=0.3, empty_docs=8, timed=True,
                           suffix="_k10000"))
    # the training slice's kernels: at its shapes (T = 512 x 128 tokens,
    # K = 2000, W = 141,043, P = 14,104 power words, Pk = 50), then at one
    # odd shape (K not a multiple of 32, a ragged last document, tokens on
    # the guard row, repeated zero rows)
    train_recs = {
        "bp_update": check_bp_update(bp_ops, gen, D=512, L=128, K=2000,
                                     W=141043, ragged=True, timed=True),
        "power_sweep_carry_train": check_carry_train(
            ops, gen, D=512, L=128, K=2000, W=141043, P=14104, Pk=50,
            ragged=True, guard_share=0.3, timed=True),
        "scatter_add_rows": check_scatter(pack_ops, gen, W=141043, K=2000,
                                          P=14104, Pk=50, dup_zero_rows=0,
                                          timed=True),
        "power_sweep_tokens": check_packed_sweep(
            packed, gen, D=512, L=128, K=2000, P=14104, Pk=50,
            guard_share=0.3, empty_doc=False, timed=True),
        "pack_rows": check_pack_rows(pack_ops, gen, W=141043, K=2000,
                                     P=14104, Pk=50, outside=False,
                                     timed=True),
        "word_rows_sum": check_word_rows_sum(seg_ops, gen, D=512, L=128,
                                             K=2000, W=141043, timed=True),
        "topic_sum": check_topic_sum(seg_ops, gen, P=14104, Pk=50, K=2000,
                                     timed=True)}
    # the fixed-order sums at odd shapes: K not a multiple of 4 (scalar
    # loads), a vocabulary of few words, K = 10,000, Pk of 1 and K
    for D, L, K, W in ((3, 7, 37, 5), (4, 16, 100, 3000), (8, 16, 10000, 50)):
        check_word_rows_sum(seg_ops, gen, D=D, L=L, K=K, W=W, timed=False)
    for P, Pk, K in ((9, 1, 100), (9, 37, 37), (300, 50, 10000)):
        check_topic_sum(seg_ops, gen, P=P, Pk=Pk, K=K, timed=False)
    # the dense sweep on both paths: the two-pass path at K = 2000 and past
    # the register path (K = 10,000); K = 100 and an odd K = 1999 (scalar
    # loads) on each path, with count-0 slots whose mu is not a
    # distribution
    check_bp_update(bp_ops, gen, D=64, L=64, K=2000, W=20000, ragged=True,
                    timed=False, twopass=True)
    check_bp_update(bp_ops, gen, D=16, L=64, K=10000, W=2000, ragged=True,
                    timed=False)
    for K in (100, 1999):
        for twopass in (False, True):
            check_bp_update(bp_ops, gen, D=3, L=7, K=K, W=50, ragged=True,
                            timed=False, twopass=twopass, junk_pad_mu=True)
    # the training sweep at Pk of 2, 5 and K, an empty document, an
    # all-guard batch (at Pk = 1 the renormalization leaves mu as it was:
    # every sum is exactly 0 and both sides return rounding noise, so the
    # relative gate has no scale; the CPU tests hold Pk = 1 against the
    # reference's oracle, the card tests run it at K = 1)
    for Pk, guard in ((2, 0.3), (5, 0.3), (100, 0.3), (37, 1.0)):
        check_carry_train(ops, gen, D=4, L=7, K=100, W=50, P=9, Pk=Pk,
                          ragged=True, guard_share=guard, empty_doc=True,
                          timed=False)
    check_scatter(pack_ops, gen, W=50, K=100, P=12, Pk=7, dup_zero_rows=3,
                  timed=False)
    # the packed slice's kernels at odd shapes: K = 100, Pk of 1, 37 and K,
    # a ragged last document, an empty document, an all-guard batch, and
    # pairs outside the matrix
    for Pk in (1, 37, 100):
        check_packed_sweep(packed, gen, D=4, L=7, K=100, P=9, Pk=Pk,
                           guard_share=0.3, empty_doc=True, timed=False)
        check_pack_rows(pack_ops, gen, W=50, K=100, P=12, Pk=Pk,
                        outside=True, timed=False)
    check_packed_sweep(packed, gen, D=4, L=7, K=100, P=9, Pk=37,
                       guard_share=1.0, empty_doc=True, timed=False)
    # Pk past 128 (the kernels' strided path), skewed rows
    check_packed_sweep(packed, gen, D=6, L=40, K=300, P=9, Pk=200,
                       guard_share=0.2, empty_doc=True, timed=False,
                       skewed=True)
    # the packed sweep at the slice's shapes with Zipf-like rows and one
    # very long row (the padding slots on word 0's row), timed
    skew = check_packed_sweep(packed, gen, D=512, L=128, K=2000, P=14104,
                              Pk=50, guard_share=0.3, empty_doc=False,
                              timed=True, skewed=True)
    train_recs["power_sweep_tokens"].update(
        {f"{key}_skewed": skew[key] for key in ("ms", "plain_ms", "bound_ms")})
    print(f"[time] phase 2: {time.time() - t0:.1f}s")

    # ---- 3. the serving slice at PUBMED width
    from repro_torch.core import infer

    t0 = time.time()
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        engine, docs, results, wall, launches, s = serve_slice(
            W=141043, K=2000, requests=args.requests, seed=args.seed,
            device="cuda", ckpt_dir=ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    want = s["steps"] * engine.sweeps_per_step
    print(f"[slice] {s['served']} requests over {s['steps']} slab steps at "
          f"W={engine.cfg.vocab_size} K={engine.cfg.num_topics}: "
          f"power_sweep_carry launches {launches} (steps x sweeps = {want})")
    if launches != want or launches <= 0:
        fail(f"the slab ran {launches} kernel launches, expected {want}")
    print(f"[slice] {len(results) / wall:.1f} docs/s  "
          f"p50={s['latency_p50_s'] * 1e3:.3f}ms  "
          f"p99={s['latency_p99_s'] * 1e3:.3f}ms  "
          f"step_ema={s['step_ema_s'] * 1e3:.3f}ms  "
          f"mean fold iters={s['mean_fold_iters']:.2f}  "
          f"slot occupancy={s['slot_occupancy']:.3f}  "
          f"warmup={s['warmup_s']:.2f}s  "
          f"peak device memory={torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB  [{card}]")
    readings = [burst_reading(engine, results, wall)]
    for _ in range(args.bursts - 1):
        readings.append(burst_reading(engine, *serve_burst(engine, docs)))
    for i, (dps, p50, p99, ema) in enumerate(readings):
        print(f"[bursts] {i + 1}: {dps:.1f} docs/s  p50={p50 * 1e3:.3f}ms  "
              f"p99={p99 * 1e3:.3f}ms  step_ema={ema * 1e3:.3f}ms")
    cols = list(zip(*readings))
    med = [sorted(c)[len(c) // 2] for c in cols]
    print(f"[bursts] median (min..max) of {len(readings)} bursts of "
          f"{len(docs)}: {med[0]:.1f} ({min(cols[0]):.1f}..{max(cols[0]):.1f})"
          f" docs/s  p50={med[1] * 1e3:.3f}ms ({min(cols[1]) * 1e3:.3f}.."
          f"{max(cols[1]) * 1e3:.3f})  p99={med[2] * 1e3:.3f}ms "
          f"({min(cols[2]) * 1e3:.3f}..{max(cols[2]) * 1e3:.3f})  "
          f"step_ema={med[3] * 1e3:.3f}ms ({min(cols[3]) * 1e3:.3f}.."
          f"{max(cols[3]) * 1e3:.3f})  [{card}]")

    # ---- 4. fixed-sweep fold-in, kernel against plain version
    from unittest import mock

    from repro_torch.data.batching import docs_to_padded

    mb = docs_to_padded(docs[:64])
    runs = []
    for sweep in (ops.power_sweep_carry, ops.power_sweep_carry_plain):
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        with mock.patch.object(infer, "power_sweep_carry", sweep):
            runs.append(infer.fold_in_tokens(
                mb, engine._phi, engine.cfg, iters=30, residual_tol=0.0,
                generator=g, device="cuda"))
    diff = float((runs[0].theta - runs[1].theta).abs().max())
    print(f"[fold-in] 64 docs x 30 sweeps (L={mb.max_len}): kernel vs "
          f"plain max|dtheta|={diff:.3e} (tol 1e-4)")
    if runs[0].iters != 30 or not diff <= 1e-4:
        fail("fixed-sweep fold-in through the kernel disagrees with the "
             "plain version")

    # ---- 5. where the time goes: the same requests again, profiled
    profile_serve(engine, docs, card)
    del engine, runs

    # ---- 3b. serving at K = 10,000 (the K-blocked path) from a checkpoint
    # the port wrote; W cut to 20,000 so the checkpoint stays 0.8 GB
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt_k10000"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        eng_k, _, res_k, wall_k, launches_k, s_k = serve_slice(
            W=20000, K=10000, requests=64, seed=args.seed, device="cuda",
            ckpt_dir=ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    want = s_k["steps"] * eng_k.sweeps_per_step
    print(f"[slice] K=10000 ({ops.serve_launch_plan(10000).path} path): "
          f"{s_k['served']} requests over {s_k['steps']} slab steps at "
          f"W={eng_k.cfg.vocab_size}: power_sweep_carry launches {launches_k} "
          f"(steps x sweeps = {want})  {len(res_k) / wall_k:.1f} docs/s  "
          f"p50={s_k['latency_p50_s'] * 1e3:.3f}ms  [{card}]")
    if launches_k != want or launches_k <= 0:
        fail(f"the K=10000 slab ran {launches_k} kernel launches, expected "
             f"{want}")
    del eng_k, res_k
    print(f"[time] phases 3-5: {time.time() - t0:.1f}s")

    # ---- 6. the training slice at PUBMED width
    from repro_torch.core.perplexity import evaluate

    t0 = time.time()
    W, K, D, L = 141043, 2000, 512, 128
    batches, (train, test) = train_data(W=W, K=K, D=D, L=L,
                                        steps=args.train_steps,
                                        seed=args.seed, device="cuda")
    print(f"[time] training data sampled in {time.time() - t0:.1f}s")
    cfg, state, step, train_launches, carry_readings = train_slice(
        batches, W=W, K=K, seed=args.seed, device="cuda", card=card)
    print(f"[train] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    repeat_step(step, state, batches[1 % len(batches)], "train", card)
    train_kernel_vs_plain(seed=args.seed)
    decay_meter_check(seed=args.seed)
    ppl = evaluate(state.phi_acc, train, test, cfg,
                   generator=torch.Generator(device="cuda").manual_seed(
                       args.seed + 1), device="cuda")
    print(f"[train] held-out perplexity after step {state.m}: {ppl:.3f} "
          f"({test.num_docs} documents, fold-in through the serving kernel)")
    (_, diag), carry_watch = profile_run(
        lambda: step(state, batches[0].word_ids, batches[0].counts),
        "one training step (batch 1 again)", card,
        watch=("bp_update", "carry_train_kernel", "carry_dr_fold_kernel",
               "scatter_add_rows_kernel", "word_rows_sum_kernel",
               "topic_sum_partial_kernel", "topic_sum_final_kernel"))
    print(f"[profile] that step ran {diag['iters']} iterations")
    if "bp_update" in carry_watch:
        # the dense sweep's bound on that step's own tokens
        lay = batches[0].token_layout()
        bound, _ = bp_bound_ms([lay.word_ids, lay.doc_ids, lay.counts,
                                torch.empty((lay.num_slots, K),
                                            device="meta")])
        ms = carry_watch["bp_update"]
        print(f"[profile] bp_update on the main path: {ms:.4f} ms a launch, "
              f"bound {bound:.4f} ms on its tokens ({bound / ms:.1%} of it "
              f"reached)")
    del state, step, diag        # phase 7 reads its own peak memory
    print(f"[time] phase 6: {time.time() - t0:.1f}s")

    # ---- 7. the packed sweep policy on the same batches and settings
    t0 = time.time()
    _, state, step, packed_launches, packed_readings = train_slice(
        batches, W=W, K=K, seed=args.seed, device="cuda",
        sweep_policy="packed", card=card)
    print(f"[packed] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    repeat_step(step, state, batches[1 % len(batches)], "packed", card)
    for i, (c, pk) in enumerate(zip(carry_readings, packed_readings)):
        print(f"[packed] step {i + 1} ms/iteration: carry "
              f"{c[0] * 1e3 / c[1]:.3f} ({c[1]} iterations), packed "
              f"{pk[0] * 1e3 / pk[1]:.3f} ({pk[1]} iterations)")
    (_, diag), packed_watch = profile_run(
        lambda: step(state, batches[0].word_ids, batches[0].counts),
        "one packed training step (batch 1 again)", card,
        watch=("bp_update", "pack_rows_kernel", "packed_sweep_kernel",
               "packed_fold_kernel", "scatter_add_rows_kernel"))
    print(f"[profile] that step ran {diag['iters']} iterations")
    del state, step, diag
    # packed against carry: one mini-batch, one init, tolerance 0, 8
    # iterations; gated at a reduced shape, timed in turns at full width
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    Wr, Kr, Dr, Lr = 20000, 256, 64, 64
    phi_true, _ = model_on_device(gen, Wr, Kr, "cuda")
    (mb,) = padded_batches(gen, phi_true, D=Dr, L=Lr, len_means=(64,))
    u0 = torch.rand((Dr, Lr, Kr), generator=gen, device="cuda") * 0.99 + 0.01
    gap, _ = packed_vs_carry(mb, u0, W=Wr, K=Kr, seed=args.seed,
                             order=("auto", "packed"))
    print(f"[packed] packed vs carry at W={Wr} K={Kr} D={Dr} L={Lr}, 8 "
          f"iterations from one init: rel L1 gap phi_acc "
          f"{gap['phi_acc']:.3e}, theta {gap['theta']:.3e} (tol 1e-4)")
    if not max(gap.values()) <= 1e-4:
        fail("the packed and carry policies disagree")
    mb = batches[1 % len(batches)]
    u0 = torch.rand((D, L, K), generator=gen, device="cuda") * 0.99 + 0.01
    gap, runs = packed_vs_carry(mb, u0, W=W, K=K, seed=args.seed)
    print(f"[packed] packed vs carry at W={W} K={K} D={D} L={L} (batch 2), 8 "
          f"iterations from one init: rel L1 gap phi_acc "
          f"{gap['phi_acc']:.3e}, theta {gap['theta']:.3e} (not gated); "
          + ", ".join(f"{pol} {ms:.3f} ms = {ms / it:.3f} ms/iteration"
                      for pol, ms, it in runs) + f"  [{card}]")
    del u0, mb
    print(f"[time] phase 7: {time.time() - t0:.1f}s")

    # ---- 8. the training driver: crash-resume, bf16 phi_acc, f32 serving
    t0 = time.time()
    driver_slice(seed=args.seed, docs=args.driver_docs, card=card)
    print(f"[time] phase 8: {time.time() - t0:.1f}s")

    rec["launches"] = launches
    kernels = [rec]
    # device ms a launch on the main path, from the profiled steps
    def summed(watch, *names):
        # device ms a launch of a wrapper that runs several device kernels
        got = [watch.get(n) for n in names]
        return None if None in got else sum(got)

    main_ms = {"bp_update": carry_watch.get("bp_update"),
               "power_sweep_carry_train": summed(
                   carry_watch, "carry_train_kernel", "carry_dr_fold_kernel"),
               "scatter_add_rows": carry_watch.get("scatter_add_rows_kernel"),
               "word_rows_sum": carry_watch.get("word_rows_sum_kernel"),
               "topic_sum": summed(carry_watch, "topic_sum_partial_kernel",
                                   "topic_sum_final_kernel"),
               "pack_rows": packed_watch.get("pack_rows_kernel"),
               "power_sweep_tokens": summed(
                   packed_watch, "packed_sweep_kernel",
                   "packed_fold_kernel")}
    for name, r in train_recs.items():
        r["launches"] = (packed_launches if name in ("power_sweep_tokens",
                                                     "pack_rows")
                         else train_launches)[name]
        r["ms_main_path"] = main_ms[name]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
