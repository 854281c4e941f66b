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
     call's time;
  3. the serving slice at PUBMED width (W = 141,043, K = 2000): a random
     phi statistic made on the card from ``--seed``, saved as a JAX-format
     checkpoint, served by ``SlabEngine.from_checkpoint`` for
     ``--requests`` documents sampled on the card from the model; every
     request must retire with a finite theta that sums to 1, and the
     kernel's launch count must equal slab steps x sweeps per step; then
     the same requests again, closed loop, until ``--bursts`` bursts are
     served in all, and the median and range of each burst's docs/s, p50,
     p99 and step_ema;
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
     in phi_acc and theta (relative L1 gap 1e-4); then held-out perplexity
     after the last step, and one more step under ``torch.profiler``;
  7. the packed sweep policy on the same batches and settings: the same
     steps with ``sweep_policy="packed"`` (the phi pack and packed-sweep
     kernels launch once per selective iteration, the carry sweep never),
     the same mass and finiteness checks, one profiled step; then one
     mini-batch from one injected init through both policies with
     tolerance 0 and 8 iterations, at a reduced shape (phi_acc and theta
     must agree to a relative L1 gap of 1e-4) and at the full width (the
     two formulations' ms per iteration side by side, in turns).

Each phase prints its wall time.  The line before the last is the kernels' JSON record; the last line is
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
    """Median device time of ``fn(*make_args())`` over ``reps`` runs, CUDA
    events around each call, L2 flushed before each (arguments are made
    outside the timed region)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn(*make_args())                                    # warm up
    times = []
    for _ in range(reps):
        args = make_args()
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


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


def check_sweep(ops, gen, *, T, D, K, rows, frozen, empty_docs, timed):
    """The serving sweep against its plain version: mu' within 1e-5,
    theta_delta and rdoc within rel 1e-4; a second launch on the same
    inputs repeats mu', theta_delta and rdoc bit for bit."""
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
    print(f"[kernel] power_sweep_carry T={T} D={D} K={K} rows={rows}: "
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
    print(f"[kernel] power_sweep_carry: {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  bound {bound * 1e3:.2f} us ({bound_by})  library: none (no "
          f"single PyTorch call computes this sweep)")
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


def bp_inputs(gen, *, D, L, K, W, ragged):
    """Inputs of one dense (t=1) sweep: random messages, theta = sum c*mu,
    phi a random statistic plus this batch's c*mu."""
    import torch

    dev = "cuda"
    T = D * L
    doc_ids, counts = doc_tokens(gen, D=D, L=L, ragged=ragged)
    word_ids = torch.randint(0, W, (T,), generator=gen, device=dev,
                             dtype=torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev) + 0.01
    mu /= mu.sum(1, keepdim=True)
    theta = torch.zeros((D, K), device=dev).index_add_(0, doc_ids.long(),
                                                       counts * mu)
    phi = torch.rand((W, K), generator=gen, device=dev).index_add_(
        0, word_ids.long(), counts * mu)
    return [word_ids, doc_ids, counts, mu, theta, phi, phi.sum(0)]


def check_bp_update(ops, gen, *, D, L, K, W, ragged, timed):
    import torch

    x = bp_inputs(gen, D=D, L=L, K=K, W=W, ragged=ragged)
    kw = dict(alpha=0.1, beta=0.01, wbeta=W * 0.01)
    got = ops.bp_update(*x, **kw)
    want = ops.bp_update_plain(*x, **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel_r = rel_err(got[1], want[1])
    print(f"[kernel] bp_update T={D * L} D={D} K={K} W={W}: max|dmu'|="
          f"{err_mu:.3e} (tol 1e-5)  rel r={rel_r:.3e} (tol 1e-4)")
    if not (err_mu <= 1e-5 and rel_r <= 1e-4):
        fail(f"bp_update disagrees with its plain version at D={D} L={L} "
             f"K={K}")
    if not timed:
        return None
    ms = time_ms(lambda *a: ops.bp_update(*a, **kw), lambda: x)
    plain_ms = time_ms(lambda *a: ops.bp_update_plain(*a, **kw), lambda: x)
    T = D * L
    n_words = int(torch.unique(x[0]).numel())
    n_docs = int(torch.unique(x[1]).numel())
    bound, bound_by = bound_ms(4 * (3 * T * K + (n_words + n_docs + 1) * K
                                    + 3 * T), 12 * T * K)
    print(f"[kernel] bp_update: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"{bound * 1e3:.2f} us ({bound_by})  library: none (no single "
          f"PyTorch call computes this sweep)")
    return kernel_record("bp_update", "src/repro_torch/csrc/bp_update.cu",
                         "src/repro/kernels/bp_update/kernel.py:56", err_mu,
                         ms, plain_ms, bound, bound_by)


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


def carry_train_bound_ms(x):
    """Least time for one training sweep on these inputs, and what bounds
    it: each distinct power word's sel_w, sel_k and phi at its Pk topics;
    each power token's mu at its Pk topics, read and written; theta at the
    distinct selected (document, topic) pairs in, theta_delta out; the
    [P, Pk] d/r buffers written once; the per-token ids and counts; phi_tot;
    ~30 f32 operations per (power token, topic)."""
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
                  + 2 * P * Pk + 3 * T + K)
    return bound_ms(nbytes, 30 * n_act * Pk)


def check_carry_train(ops, gen, *, D, L, K, W, P, Pk, ragged, guard_share,
                      timed, empty_doc=False):
    """The training sweep against its plain version: mu' within 1e-5,
    theta_delta, d_pack and r_pack within rel 1e-4; mu outside the power
    tokens' selections bit for bit as it was; a second launch repeats mu'
    and theta_delta bit for bit."""
    import torch

    x = carry_train_inputs(gen, D=D, L=L, K=K, W=W, P=P, Pk=Pk,
                           ragged=ragged, guard_share=guard_share,
                           empty_doc=empty_doc)
    kw = dict(alpha=0.1, beta=0.01, wbeta=141043 * 0.01)

    def fresh():
        a = list(x)
        a[3] = x[3].clone()
        return a

    got = ops.power_sweep_carry_train(*fresh(), **kw)
    again = ops.power_sweep_carry_train(*fresh(), **kw)
    want = ops.power_sweep_carry_train_plain(*fresh(), **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel = [rel_err(g, w) for g, w in zip(got[1:], want[1:])]
    off = ~selected_mask(x[3], x[0], x[8], P)
    kept = bool(torch.equal(got[0][off], x[3][off]))
    same = all(bool(torch.equal(g, a)) for g, a in zip(got[:2], again[:2]))
    print(f"[kernel] power_sweep_carry_train T={D * L} D={D} K={K} P={P} "
          f"Pk={Pk} guard={guard_share}: max|dmu'|={err_mu:.3e} (tol 1e-5)  "
          f"rel dtheta={rel[0]:.3e}  rel d_pack={rel[1]:.3e}  rel r_pack="
          f"{rel[2]:.3e} (tol 1e-4)  untouched bit for bit: {kept}  "
          f"relaunch bit for bit: {same}")
    if not (err_mu <= 1e-5 and max(rel) <= 1e-4 and kept and same):
        fail(f"power_sweep_carry_train disagrees with its plain version at "
             f"D={D} L={L} K={K} P={P} Pk={Pk}")
    if not timed:
        return None
    ms = time_ms(lambda *a: ops.power_sweep_carry_train(*a, **kw), fresh)
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
    """The row scatter at distinct rows and topics (as top-k selects them);
    ``dup_zero_rows`` trailing slots repeat one row with zero values."""
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
          f"max|dmat|={err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        fail(f"scatter_add_rows disagrees with its plain version at W={W} "
             f"K={K} P={P}")
    if not timed:
        return None
    del want, got
    args = lambda: (mat, sel_w, sel_k, vals)          # noqa: E731
    rows = sel_w.long()[:, None].expand(-1, Pk)
    cols = sel_k.long()
    ms = time_ms(ops.scatter_add_rows, args)
    plain_ms = time_ms(ops.scatter_add_rows_plain, args)
    library_ms = time_ms(lambda m, w, k, v: m.index_put_((rows, cols), v,
                                                         accumulate=True),
                         args)
    bound, bound_by = bound_ms(4 * (P + 4 * P * Pk), P * Pk)
    print(f"[kernel] scatter_add_rows: {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  bound {bound * 1e3:.2f} us ({bound_by})  library "
          f"(index_put_, accumulate) {library_ms:.4f} ms")
    return kernel_record("scatter_add_rows", "src/repro_torch/csrc/power_pack.cu",
                         "src/repro/kernels/power_pack/kernel.py:75", err, ms,
                         plain_ms, bound, bound_by, library_ms)


def packed_inputs(gen, *, D, L, K, P, Pk, guard_share, empty_doc):
    """Inputs of one packed sweep: doc-contiguous tokens with a ragged last
    document, a ``guard_share`` of them on the guard id P (and, with
    ``empty_doc``, all of document 0, whose counts are 0), each power row's
    Pk distinct topics, phi_pack above each token's own count."""
    import torch

    dev = "cuda"
    T = D * L
    doc_ids, counts = doc_tokens(gen, D=D, L=L, ragged=True)
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
                       empty_doc, timed):
    """The packed sweep against its plain version: mu', theta_delta, d_pack
    and r_pack at rel 1e-5 (max |gap| over max |plain|); every coordinate
    outside the power tokens' selections bit for bit as it was."""
    import torch

    x = packed_inputs(gen, D=D, L=L, K=K, P=P, Pk=Pk,
                      guard_share=guard_share, empty_doc=empty_doc)
    kw = dict(alpha=0.1, beta=0.01, wbeta=141043 * 0.01)

    def fresh():
        a = list(x)
        a[3] = x[3].clone()
        return a

    got = packed.power_sweep_tokens(*fresh(), **kw)
    want = packed.power_sweep_tokens_plain(*fresh(), **kw)
    torch.cuda.synchronize()
    err_mu = float((got[0] - want[0]).abs().max())
    rel = [rel_err(g, w) for g, w in zip(got, want)]
    off = ~selected_mask(x[3], x[0], x[7], P)
    kept = bool(torch.equal(got[0][off], x[3][off]))
    print(f"[kernel] power_sweep_tokens T={D * L} D={D} K={K} P={P} Pk={Pk} "
          f"guard={guard_share}: rel mu'={rel[0]:.3e}  rel dtheta="
          f"{rel[1]:.3e}  rel d_pack={rel[2]:.3e}  rel r_pack={rel[3]:.3e} "
          f"(tol 1e-5)  untouched bit for bit: {kept}")
    if not (max(rel) <= 1e-5 and kept):
        fail(f"power_sweep_tokens disagrees with its plain version at "
             f"D={D} L={L} K={K} P={P} Pk={Pk}")
    if not timed:
        return None
    ms = time_ms(lambda *a: packed.power_sweep_tokens(*a, **kw), fresh)
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
    print(f"[kernel] power_sweep_tokens: {ms:.4f} ms  plain {plain_ms:.4f} "
          f"ms  bound {bound * 1e3:.2f} us ({bound_by})  library: none (no "
          f"single PyTorch call computes this sweep)")
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
    ms = time_ms(pack_ops.pack_rows, args)
    plain_ms = time_ms(pack_ops.pack_rows_plain, args)
    library_ms = time_ms(lambda m, w, k: m[rows, cols], args)
    bound, bound_by = bound_ms(4 * (P + 3 * P * Pk), 0)
    print(f"[kernel] pack_rows: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"{bound * 1e3:.2f} us ({bound_by})  library (mat[sel_w[:, None], "
          f"sel_k]) {library_ms:.4f} ms")
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
    from repro_torch.kernels.power_sweep import ops
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

    ops.power_sweep_carry.launches = 0           # the main path starts here
    results, wall = serve_burst(engine, docs)
    launches = ops.power_sweep_carry.launches    # ... and ends here

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
    from repro_torch.core import pobp, power
    from repro_torch.kernels.bp_update import ops as bp_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops as sweep_ops

    return {"bp_update": (bp_ops.bp_update, pobp, "bp_update",
                          bp_ops.bp_update_plain),
            "power_sweep_carry_train": (
                sweep_ops.power_sweep_carry_train, pobp,
                "power_sweep_carry_train",
                sweep_ops.power_sweep_carry_train_plain),
            "scatter_add_rows": (pack_ops.scatter_add_rows, power,
                                 "_scatter_add",
                                 pack_ops.scatter_add_rows_plain)}


def launch_counts(reset: bool = False):
    """The main-path launch counts of the training kernels (set to 0 first
    when ``reset``)."""
    from repro_torch.kernels.bp_update import ops as bp_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops as sweep_ops
    from repro_torch.kernels.power_sweep import packed

    counters = {"bp_update": (bp_ops.bp_update, "launches"),
                "power_sweep_carry_train": (sweep_ops.power_sweep_carry_train,
                                            "launches"),
                "scatter_add_rows": (pack_ops.scatter_add_rows, "launches"),
                "power_sweep_tokens": (packed.power_sweep_tokens,
                                       "launches"),
                "pack_rows": (pack_ops.pack_rows, "launches")}
    if reset:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


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
    want = {"bp_update": len(batches),
            "power_sweep_carry_train": 0 if packed else sweeps,
            "scatter_add_rows": sweeps,
            "power_sweep_tokens": sweeps if packed else 0,
            "pack_rows": sweeps if packed else 0}
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
    """Check (d): one mini-batch from one injected init through the three
    kernels and through their plain versions.  phi_acc and theta of the
    step must agree to a relative L1 gap of 1e-4 (the atomics only reorder
    sums); iterations and held-out perplexity are printed."""
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


def profile_run(fn, label: str, card: str):
    """Run ``fn`` once under ``torch.profiler`` and print the card's busy
    share of the wall time (the summed time of the events that ran on the
    card: kernels, copies, fills), the top of those by device time and the
    top host operations by their own CPU time.  Returns what ``fn``
    returned."""
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
    dev_us, host_us = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0))
            dev_us[e.key] = dev_us.get(e.key, 0.0) + t
        else:
            host_us[e.key] = e.self_cpu_time_total
    if not sum(dev_us.values()):
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
        return out
    busy = sum(dev_us.values()) / 1e6
    print(f"[profile] {label} in {wall * 1e3:.3f} ms wall: "
          f"device busy {busy * 1e3:.3f} ms ({busy / wall:.1%}), idle "
          f"{1 - busy / wall:.1%}  [{card}]")
    for name, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {t / 1e3:9.3f} ms  {t / 1e6 / busy:6.1%}  "
              f"{name[:90]}")
    for name, t in sorted(host_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] host {t / 1e3:9.3f} ms  {name[:80]}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--bursts", type=int, default=9,
                    help="closed-loop bursts of the requests, the first "
                         "(counted) one included")
    ap.add_argument("--train-steps", type=int, default=3,
                    help="POBP steps of the training slices (phases 6, 7)")
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

    # ---- 1. build
    t0 = time.time()
    libs = build.build_all(["power_sweep_carry", "bp_update", "power_pack",
                            "power_sweep_tokens"])
    card = card_line()
    print(card)
    print(f"[build] {len(libs)} kernel(s) in {time.time() - t0:.1f}s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 2. each kernel against its plain version
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rec = check_sweep(ops, gen, T=4096, D=64, K=2000, rows=141044,
                      frozen=0.3, empty_docs=8, timed=True)
    # odd shapes: the scalar path (K = 37, 1), K = 100, the limit K = 8192
    for T, D, K in ((21, 3, 100), (21, 3, 37), (40, 5, 1), (256, 4, 8192)):
        check_sweep(ops, gen, T=T, D=D, K=K, rows=50, frozen=0.3,
                    empty_docs=1, timed=False)
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
                                     timed=True)}
    check_bp_update(bp_ops, gen, D=3, L=7, K=100, W=50, ragged=True,
                    timed=False)
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
    train_kernel_vs_plain(seed=args.seed)
    ppl = evaluate(state.phi_acc, train, test, cfg,
                   generator=torch.Generator(device="cuda").manual_seed(
                       args.seed + 1), device="cuda")
    print(f"[train] held-out perplexity after step {state.m}: {ppl:.3f} "
          f"({test.num_docs} documents, fold-in through the serving kernel)")
    diag = profile_run(
        lambda: step(state, batches[0].word_ids, batches[0].counts),
        "one training step (batch 1 again)", card)[1]
    print(f"[profile] that step ran {diag['iters']} iterations")
    del state, step, diag        # phase 7 reads its own peak memory
    print(f"[time] phase 6: {time.time() - t0:.1f}s")

    # ---- 7. the packed sweep policy on the same batches and settings
    t0 = time.time()
    _, state, step, packed_launches, packed_readings = train_slice(
        batches, W=W, K=K, seed=args.seed, device="cuda",
        sweep_policy="packed", card=card)
    print(f"[packed] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    for i, (c, pk) in enumerate(zip(carry_readings, packed_readings)):
        print(f"[packed] step {i + 1} ms/iteration: carry "
              f"{c[0] * 1e3 / c[1]:.3f} ({c[1]} iterations), packed "
              f"{pk[0] * 1e3 / pk[1]:.3f} ({pk[1]} iterations)")
    diag = profile_run(
        lambda: step(state, batches[0].word_ids, batches[0].counts),
        "one packed training step (batch 1 again)", card)[1]
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

    rec["launches"] = launches
    kernels = [rec]
    for name, r in train_recs.items():
        r["launches"] = (packed_launches if name in ("power_sweep_tokens",
                                                     "pack_rows")
                         else train_launches)[name]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
