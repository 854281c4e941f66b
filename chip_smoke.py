"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py [--seed 0] [--requests 512] [--bursts 9]
                          [--train-steps 3]

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit.  Phases, in order (16 runs right after 9); any failure exits
non-zero:

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
     run in a fixed order since the fold kernel), and again at the k2000
     cell's shapes and skew (a word in every document, runs of 64, 65, 1
     and no token, the rest Zipf-like), timed with its d/r fold's own
     device time and bound; the two fixed-order sums
     the port adds (the word-row scatter, bit for bit against its plain
     version on the CPU and timed in turns with ``index_add_`` with and
     without PyTorch's deterministic algorithms; the phi_tot refresh's
     per-topic sum), each repeating bit for bit; a live-W selection's
     dead slots (the trailing slots of ``sel_w`` on one all-zero row that
     no token has) through the carry training sweep, the packed sweep and
     the pack, the sweeps repeating bit for bit, the dead slots' outputs
     exactly 0; the phi_tot refresh's sum also at one row, rows that do
     not divide evenly, Pk of 1 and K = 10,000; and the Gibbs chain kernel
     (phase 12's) with injected noise and with its Philox pre-pass's,
     equal to its plain version exactly: timed at W = 20,000, T = 4096,
     K = 2000 with its bounds, the floor of its one-barrier argmax and its
     block sizes in turns, then at K = 1, 33, 2049, 10,000 and past its
     shared-memory caches, every draw a tie, a shuffled token order, words
     repeated in consecutive tokens and across documents, one-token
     documents and noise off 16-byte boundaries; the Philox pre-pass
     equal to its plain version, timed with its peak memory; the
     power-topic selection id for id against its plain version (spread
     rows, tie rows, dead slots on an all-zero row), repeating bit for
     bit, timed at P = 14,104, Pk = 50, K = 2000 and 10,000 with its
     bound, all-zero rows, and the library route it replaced (the [P, K]
     gather, then torch.topk), then at odd widths;
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
     the kernels' launches net of the warm-up are printed;
  9. multi-shard sync at PUBMED width: (a) ``make_train_step(cfg, 4)``,
     four data shards in lockstep on the card, over phase 6's mini-batches
     split 4 x 128 documents: every training kernel launched 4 x its
     single-shard count, phi_acc holding every token, the meter's dense and
     power bytes Eq. 5/6's, one mini-batch twice from one state equal bit
     for bit, the shards' phi_acc identical bit for bit, the step walls
     beside phase 6's; (b) the driver's ``--backend shard_map``, 2
     mini-batches of ``--driver-docs`` documents: a 2 x 2 mesh of four gloo
     ranks on the one card (every rank's iterations and mean_r alike, rank
     0's checkpoint a global [W, K] phi_acc holding every token, the
     model-axis phases in the meter; with the topics sharded the dense
     sweep runs the reference's formulation in torch code, as the
     reference runs jnp code there), a 1 x 1 NCCL mesh equal to one shard
     bit for bit, a 2 x 2 NCCL mesh where four cards allow; (c)
     ``SlabEngine(topic_shards=4)`` from phase 3's checkpoint, 64 requests
     (torch code, as the reference's sharded serving is jnp): each theta
     within 1e-5 of the unsharded engine's, the model psums billed per
     retired document, docs/s beside phase 3's;
 10. the dynamic vocabulary and the stream lifecycle through the driver at
     PUBMED width (``lifecycle_slice``; phase 8's settings, K = 2000,
     ``--dynamic-vocab`` over 141,043 external words): (a) 4 mini-batches
     growing the state at least twice to a rung >= 131,072, every training
     kernel launched, guard rows exactly 0, every token held, a live-W
     mini-batch repeating bit for bit; (b) ``--crash-at 3`` and the rerun,
     equal to (a) bit for bit; (c) a grown run against a fresh run at its
     final rung within rtol 1e-6; (d) the sliding stream with decay and a
     fence every 2 mini-batches (4 of them): a fence reclaims rows, a
     dropped rung's bytes are freed, a crash-resume across a fence equal
     bit for bit, and 64 requests served from the last post-compaction
     checkpoint; (e) topic recycling at a reduced width (W = 20,000,
     K = 2000): the sliding stream with ``--recycle-tol 1`` (every topic at
     or under the mean mass), a recycle at each fence in float32 and in
     bf16 phi_acc (the host round trip in the storage dtype), and
     ``--crash-at 3`` then again through the recycling fence, equal bit for
     bit;
 11. the parameter server through the driver at PUBMED width
     (``ps_slice``; phase 8's settings with ``--backend ps --ps-servers 4``):
     (a) ``--staleness 0``: iterations equal to phase 8 (a)'s ``--backend
     sim`` batch by batch, phi_acc within a relative L1 gap of 1e-5 and
     mean_r within 1e-6 of it, the training kernels launched as often as
     its steps and iterations, every token held, the measured wire bytes
     beside the meter's touched-row model and ``touched_power_sync_bytes``
     at the measured mean touched rows; (b) (a) under a seeded chaos plan
     (drops, duplicates, shard 1 crashing at push op 2 and restarting one
     op later): equal to (a) bit for bit, a recovery run; (c) (a) with
     elastic workers (a join, a leave, a crash of the assigned worker, so a
     survivor replays its batch): equal to (a) bit for bit; (d)
     ``--crash-at 3`` then again: it resumes at m = 2 and ends equal to (a)
     bit for bit (else the first batch that differs is named); (e)
     ``--staleness 1 --ps-latency 0.001``: finite, every token held, its
     pull and push waits beside (a)'s; (f) per batch the touched rows and
     the replica's two copies (host to card before the step, card to host
     after it: ms and GB/s against the PCIe bound), the server's
     ``np.add.at`` per push, and the step walls beside phase 8 (a)'s.
     The kernels' launches in the JSON line include phase 9 (a)'s, phase
     10 (a)'s and phase 11 (a)'s;
 12. the paper's comparators at PUBMED width (W = 141,043, K = 2000),
     on phase 6's first mini-batch and held-out split: (a) ``run_gibbs``,
     3 sweeps with the chain kernel on the Philox pre-pass's noise from
     ``--seed`` (the counts holding every token, n_k the column sums of
     n_wk, every count a non-negative integer, one chain and one pre-pass
     launch a sweep, a second run equal bit for bit; ms a sweep, us a
     token, held-out perplexity beside phase 6's); (b) ``run_vb``, 5
     iterations from one injected lambda (lambda - beta holding every
     token, gamma finite, a second run equal bit for bit; ms an iteration,
     held-out perplexity); (c) the chain kernel against its plain version
     with injected and Philox noise, equal exactly, at the main path's
     shape (phase 2 holds the other shapes); (d) PGS and PVB over 4 shards
     of 128
     documents, 2 sweeps and 2 iterations (``comm_bytes`` W*K*4*4 each,
     the tokens held, the shared n_wk untouched by each shard's sweep); (e)
     the reference accuracy bench's Table 4 analogue at its own settings
     (W = 400, K = 16): POBP, GS and VB each below a random model's
     held-out perplexity.  The JSON line's ``gibbs_sweep`` and
     ``gibbs_noise`` launches are (a)'s; ``word_rows_sum`` adds (b)'s;
 13. LM serving (the LM lab's plain PyTorch path, no kernel of its own):
     ``serve --mode lm`` (``serve_lm``) at full width and depth for
     smollm-360m (8 streams, prompt 128, 128 new tokens) and
     deepseek-v2-lite-16b (8 streams, prompt 32, 32 new tokens), each
     twice from ``--seed`` (logits finite, greedy tokens in the
     vocabulary, the second run equal bit for bit; tokens/s, ms a decode
     step, peak memory, one decode step profiled); then, for each of the
     ten ``--arch`` ids at ``reduced()`` and for smollm-360m at full
     width, a prefill of 16 tokens and a decode of the 17th against a
     full forward over 17;
 14. LM training through ``launch/train.py`` (``lm_train_slice``): (a)
     smollm-360m at full width and depth, 2 lockstep shards of 4 x 4096
     tokens, PowerSync (its pack and two scatters on the power-pack
     kernels), 12 steps, a checkpoint every 4: losses finite and falling;
     ms a step (median and range of steps 3-12, the loss read a step),
     tokens/s, peak device memory, the bytes a step by phase, step 2
     profiled; (b) ``--crash-at 8``, then the same command again: steps
     9-12 equal to (a)'s bit for bit, else within the reference's rtol =
     atol = 2e-4 (which held is printed); (c) (a)'s cell with ``--sync
     dense``: PowerSync's payload under 0.25 x the dense bytes, the two
     loss curves and step walls side by side; (d) mamba2-780m at full
     width and depth, 2 x 4 x 2048, remat ``"full"``, 6 steps: losses
     finite and falling, ms a step, tokens/s, peak memory; (e) the ten ids
     at ``reduced()``: ``loss_fn`` and its grads in float32 on the card
     against the CPU (loss rtol 1e-4, each grad leaf a relative L2 error
     of at most 1e-3), and PowerSync over 2 shards on the card through
     the kernels against their plain versions (synced within 1e-6, the
     residuals and sent masks equal), on a tree of odd leaves and on a
     tree of smollm-360m's full-width leaf shapes.  The counts are reset
     before each of (a)-(d) and read right after it; each run's
     ``pack_rows`` launches must be exactly steps x 2 shards x the leaves
     PowerSync packs, its ``scatter_add_rows`` launches twice that ((c)'s
     zero).  The JSON line's launches of the two kernels include (a)'s;
 15. the last modules of the JAX package (no kernel of their own): (a)
     ``python -m repro_torch.launch.dryrun`` for three cells, each a CPU
     process of its own (a fake process group of 512) run beside (c) and
     (d): smollm-360m ``train_4k`` (params 361,821,120, chips 256, model
     FLOPs 8,892,115,845,120: the in-repo reference record's), deepseek-
     v2-lite-16b ``decode_32k`` (the decode cache's specs, the MoE island
     on the fake mesh) and ``--lda`` at K = 2000 (the analytic bytes the
     port's Eq. 5/6 formulas), each ``ok``, the counted terms printed beside
     the reference record's XLA terms; (b) ``roofline.model_flops`` of phase
     14 (a)'s step over its median times the data-sheet bf16 peak; (c) the
     MoE's expert-parallel island at full width (deepseek-v2-lite-16b cut
     to its dense first layer and 2 MoE layers, a prefill of 8 x 128) on a
     1 x 1 NCCL mesh in this process and a 1 x 2 gloo mesh of two processes
     on the one card: each MoE layer within rtol = atol = 2e-2 (aux rtol
     1e-4) of the local path on the same input, the prefill's logits under
     PR 24's near-tie rule, the two ranks equal bit for bit, each rank's
     peak memory; (d) ``powersync_tree`` on an olmoe-1b-7b expert leaf of
     2^31 float32 elements through the power-pack kernels, equal to their
     plain versions at every pair;
 16. (run right after phase 9, while phase 3's checkpoint is on disk)
     topic-sharded serving over a mesh (the engines'
     ``from_checkpoint(sharding=(mesh, phi_serving_spec(mesh, phi)))``)
     from phase 3's checkpoint at PUBMED width: (a) a 1 x 1 NCCL mesh in
     this process, ``SlabEngine`` serving phase 3's requests with one seed
     and ``pipeline=0``: every theta equal to the unplaced engine's bit for
     bit, the serving kernel launched steps x sweeps times (its launches in
     the JSON line include these); (b) a 1 x 2 gloo mesh of two processes
     on the one card, ``SlabEngine`` and ``FoldInEngine`` each serving the
     first 256 of those requests, each rank holding its [141,044, 1000]
     f32 block: thetas finite and summing to 1 +- 1e-5, within 1e-5 of the
     one-process ``topic_shards=2`` engines (same seed and requests), the
     two ranks equal bit for bit, the bytes by phase the one-process
     engines' integer for integer, each rank's peak memory below theirs;
     docs/s, the peaks and the theta gather's bytes printed.

Phase 10 draws each host batch of its drifting streams once
(``drawn_once``): its runs read the same batches.  Each phase prints its
wall time.  The line before the last is the
kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
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
            "share_of_bound": bound / ms if ms else None,
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


def dead_slots(sel_w, sel_k, dead: int, row: int) -> None:
    """A live-W selection's tail, in place: the last ``dead`` slots all on
    ``row`` (a guard row, all zeros, that no token has), each with the
    topics of the slot before them (a tie over a zero row)."""
    sel_w[-dead:] = row
    sel_k[-dead:] = sel_k[-dead - 1]


def carry_train_inputs(gen, *, D, L, K, W, P, Pk, ragged, guard_share,
                       empty_doc=False, dead=0, skewed=False):
    """Inputs of one training-mode selective sweep: tokens on P power rows
    or (a ``guard_share`` of them, and with ``empty_doc`` all of document
    0, whose counts are 0) the guard id P; P distinct power words of a
    [W, K] phi and Pk distinct topics for each.  With ``dead``, the last
    ``dead`` slots are a live-W selection's dead slots (`dead_slots`):
    no token on them, their row all zeros in phi.  Rows are uniform, or
    with ``skewed`` (P >= 6) the runs of the d/r fold's edges at the
    cells' skew: row 0 has the first slot of every document (a run of
    about D counted tokens, like a head word), rows 1, 2 and 3 runs of
    exactly C = FOLD_CHUNK, C + 1 and 1 counted tokens, row 4 none, and
    the other rows are drawn Zipf-like with weight 1 / (rank + 13), so
    that the longest of them, too, is about D tokens at L = 128."""
    import torch

    from repro_torch.kernels.token_order import FOLD_CHUNK

    dev = "cuda"
    T = D * L
    doc_ids, counts = doc_tokens(gen, D=D, L=L, ragged=ragged)
    if skewed:
        zipf = 1.0 / torch.arange(14, P + 9, device=dev, dtype=torch.float32)
        p_tok = torch.multinomial(zipf, T, replacement=True, generator=gen) + 5
    else:
        p_tok = torch.randint(0, P, (T,), generator=gen, device=dev)
    guard = torch.rand(T, generator=gen, device=dev) < guard_share
    if empty_doc:
        guard |= doc_ids == 0
        counts[doc_ids == 0] = 0.0
    if skewed:
        C = FOLD_CHUNK
        head = torch.arange(L, device=dev).repeat(D) == 0
        guard &= ~head
        p_tok[head] = 0
        free = (~head & (counts[:, 0] > 0)).nonzero().squeeze(1)
        pick = free[torch.randperm(free.numel(), generator=gen,
                                   device=dev)[:2 * C + 2]]
        p_tok[pick[:C]] = 1
        p_tok[pick[C:2 * C + 1]] = 2
        p_tok[pick[2 * C + 1]] = 3
        guard[pick] = False
    p_tok = torch.where(guard, P, p_tok).to(torch.int32)
    mu = torch.rand((T, K), generator=gen, device=dev) + 0.01
    mu /= mu.sum(1, keepdim=True)
    theta = torch.zeros((D, K), device=dev).index_add_(0, doc_ids.long(),
                                                       counts * mu)
    phi = torch.rand((W, K), generator=gen, device=dev) * 5
    perm = torch.randperm(W, generator=gen, device=dev).to(torch.int32)
    sel_w = perm[:P].clone()
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    if dead:
        p_tok = torch.where(p_tok >= P - dead, P, p_tok).to(torch.int32)
        dead_slots(sel_w, sel_k, dead, int(perm[P]))
        phi[int(perm[P])] = 0.0
    phi_tot = phi[sel_w.long()].sum(0) + 30.0
    return [p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k]


def carry_train_runs(x, W):
    """The tokens' runs by word, as the training step makes them once per
    mini-batch (``TokenLayout.word_runs``): a power token's word is its
    row's ``sel_w``, a guard token's a word outside the selection."""
    import torch

    from repro_torch.kernels.token_order import token_runs

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


def carry_fold_bound_ms(x, runs):
    """Least time for the d/r fold on these inputs, and what bounds it:
    each counted power token's cd row of Pk floats and its run position
    read, the [P, Pk] d/r rows written once, each power row's sel_w and
    two starts; two adds and an abs per (token, topic)."""
    p_tok, sel_w, sel_k = x[0], x[7], x[8]
    P, Pk = sel_k.shape
    n = int(runs[1].diff().index_select(0, sel_w.long()).sum())
    return bound_ms(4 * (n * (Pk + 1) + 2 * P * Pk + 3 * P), 3 * n * Pk)


def check_carry_train(ops, gen, *, D, L, K, W, P, Pk, ragged, guard_share,
                      timed, empty_doc=False, dead=0, skewed=False):
    """The training sweep against its plain version: mu' within 1e-5,
    theta_delta, d_pack and r_pack within rel 1e-4 (the sums' order
    differs); mu outside the power tokens' selections bit for bit as it
    was; a second launch repeats all four outputs bit for bit.  The kernel
    is given the tokens' runs by word and their chunks, made beforehand as
    the training step makes them once per mini-batch.  With ``dead`` dead
    slots (`dead_slots`), their d/r must be exactly 0; with ``skewed``
    (`carry_train_inputs`), row 4's, whose run is empty.  Timed and
    ``skewed``, the d/r fold's own device time a launch too (`profile_run`
    over five calls), beside its bound (`carry_fold_bound_ms`)."""
    import torch

    from repro_torch.kernels.token_order import token_chunks

    x = carry_train_inputs(gen, D=D, L=L, K=K, W=W, P=P, Pk=Pk,
                           ragged=ragged, guard_share=guard_share,
                           empty_doc=empty_doc, dead=dead, skewed=skewed)
    runs = carry_train_runs(x, W)
    kw = dict(alpha=0.1, beta=0.01, wbeta=141043 * 0.01, runs=runs,
              chunks=token_chunks(runs[1]))

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
    same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
    zero = not dead or not (got[2][-dead:].any() or got[3][-dead:].any())
    if skewed:
        zero = zero and not (got[2][4].any() or got[3][4].any())
    longest = int(runs[1].diff().index_select(0, x[7].long()).max())
    print(f"[kernel] power_sweep_carry_train T={D * L} D={D} K={K} P={P} "
          f"Pk={Pk} guard={guard_share}"
          + (f" dead slots={dead}" if dead else "")
          + (f" skewed (longest power row's run {longest}, "
             f"{kw['chunks'].numel()} chunks of split runs)" if skewed
             else "") + f": max|dmu'|="
          f"{err_mu:.3e} (tol 1e-5)  "
          f"rel dtheta={rel[0]:.3e}  rel d_pack={rel[1]:.3e}  rel r_pack="
          f"{rel[2]:.3e} (tol 1e-4)  untouched bit for bit: {kept}  "
          f"relaunch bit for bit (mu', dtheta, d_pack, r_pack): {same}"
          + (f"  dead slots' d/r exactly 0: {zero}" if dead else "")
          + (f"  empty run's d/r exactly 0: {zero}" if skewed else ""))
    if not (err_mu <= 1e-5 and max(rel) <= 1e-4 and kept and same and zero):
        fail(f"power_sweep_carry_train disagrees with its plain version, or "
             f"does not repeat bit for bit, at D={D} L={L} K={K} P={P} "
             f"Pk={Pk}")
    if not timed:
        return None
    del got, again, want
    ms = time_ms(lambda *a: ops.power_sweep_carry_train(*a, **kw), fresh)
    plain_ms = time_ms(lambda *a: ops.power_sweep_carry_train_plain(*a, **kw),
                       fresh)
    bound, bound_by = carry_train_bound_ms(x)
    tag = " skewed" if skewed else ""
    print(f"[kernel] power_sweep_carry_train{tag}: {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {bound * 1e3:.2f} us ({bound_by})  "
          f"library: none (no single PyTorch call computes this sweep)")
    if skewed:
        def calls():
            for _ in range(5):
                ops.power_sweep_carry_train(*fresh(), **kw)

        fold = profile_run(calls, "5 skewed carry training sweeps",
                           card_line(), watch=("carry_dr_fold",)
                           )[1].get("carry_dr_fold")
        fold_bound, fold_by = carry_fold_bound_ms(x, runs)
        print(f"[kernel] power_sweep_carry_train{tag}: its d/r fold "
              + (f"{fold:.4f} ms a launch" if fold is not None else
                 "not measured (the profiler saw no device time)")
              + f"  bound {fold_bound * 1e3:.2f} us ({fold_by})")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "fold_ms": fold, "fold_bound_ms": fold_bound}
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

    from repro_torch.kernels.token_order import token_runs

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


def topics_rows(gen, *, P, K, ties):
    """[P + 3, K] residual rows like the training step's: a word's token
    count times |mu' - mu| of two Dirichlet(0.1) draws; with ``ties``
    every row quantized to four values; the last three rows all zero."""
    import torch

    conc = torch.full((P + 3, K), 0.1, device="cuda")
    a, b = (torch._standard_gamma(conc, generator=gen) for _ in range(2))
    counts = torch.randint(1, 400, (P + 3, 1), generator=gen, device="cuda")
    r = counts * (a / a.sum(1, keepdim=True) - b / b.sum(1, keepdim=True)
                  ).abs()
    if ties:
        r = (r / r.amax(1, keepdim=True) * 4).floor() / 4
    r[P:] = 0.0
    return r.contiguous()


def check_power_topics(topics_ops, gen, *, P, K, Pk, timed):
    """The power-topic selection against its plain version (the stable
    sort of the rows' order keys) id for id, on rows like the step's, on
    tie rows and with dead slots on an all-zero guard row, repeating bit
    for bit; timed with its plain version, the library route it replaced
    (the [P, K] gather, then ``torch.topk``) and ``torch.topk`` on rows
    gathered beforehand, and on all-zero rows (no slow path)."""
    import torch

    for ties in (False, True):
        r = topics_rows(gen, P=P, K=K, ties=ties)
        W = r.shape[0]
        sel_w = torch.randperm(W, generator=gen, device="cuda")[:P].to(
            torch.int32)
        sel_w[-min(P, 7):] = W - 1
        got = topics_ops.power_topics(r, sel_w, Pk)
        again = topics_ops.power_topics(r, sel_w, Pk)
        want = topics_ops.power_topics_plain(r, sel_w, Pk)
        same, exact = bool(torch.equal(got, again)), bool(torch.equal(got,
                                                                      want))
        print(f"[kernel] power_topics P={P} K={K} Pk={Pk} "
              f"{'tie' if ties else 'spread'} rows: ids equal to the plain "
              f"version {exact}; relaunch bit for bit {same}")
        if not (exact and same):
            fail(f"power_topics disagrees with its plain version or does "
                 f"not repeat at P={P} K={K} Pk={Pk}")
    if not timed:
        return None
    r = topics_rows(gen, P=P, K=K, ties=False)
    sel_w = torch.randperm(r.shape[0], generator=gen, device="cuda")[:P].to(
        torch.int32)
    zeros = torch.zeros_like(r)
    rows = r[sel_w.long()]
    args = lambda: (r, sel_w, Pk)                           # noqa: E731
    ms = time_turns({
        "kernel": (topics_ops.power_topics, args),
        "zeros": (topics_ops.power_topics, lambda: (zeros, sel_w, Pk)),
        "plain": (topics_ops.power_topics_plain, args),
        "route": (lambda m, w, k: torch.topk(m[w.long()], k, dim=1).indices
                  .to(torch.int32), args),
        "topk": (lambda x, k: torch.topk(x, k, dim=1), lambda: (rows, Pk))})
    bound, bound_by = bound_ms(4 * P * (K + 1 + Pk), 0)
    print(f"[kernel] power_topics P={P} K={K} Pk={Pk}: {ms['kernel']:.4f} ms "
          f"(all-zero rows {ms['zeros']:.4f})  plain {ms['plain']:.4f} ms  "
          f"bound {bound:.4f} ms ({bound_by}, {bound / ms['kernel']:.1%})  "
          f"library: gather + torch.topk {ms['route']:.4f} ms, torch.topk "
          f"on gathered rows {ms['topk']:.4f} ms")
    return kernel_record(
        "power_topics", "src/repro_torch/csrc/power_topics.cu",
        "none (added by the port): the row gather and lax.top_k of "
        "src/repro/core/power.py:74", 0.0, ms["kernel"], ms["plain"], bound,
        bound_by, ms["topk"], P=P, K=K, Pk=Pk, zero_rows_ms=ms["zeros"],
        library_route_ms=ms["route"])


def packed_inputs(gen, *, D, L, K, P, Pk, guard_share, empty_doc,
                  skewed=False, dead=0):
    """Inputs of one packed sweep: doc-contiguous tokens with a ragged last
    document, a ``guard_share`` of them on the guard id P (and, with
    ``empty_doc``, all of document 0, whose counts are 0), each power row's
    Pk distinct topics, phi_pack above each token's own count.  Rows are
    uniform, or with ``skewed`` drawn Zipf-like (weight 1 / rank) with each
    document's padding slots (a random quarter to all of its length, count
    0) on row 0, the padding word's row: one very long row, as the main
    path has when word 0 is a power word.  With ``dead``, the last
    ``dead`` rows are a live-W selection's dead slots: no token on them,
    their phi_pack rows zero (the packed guard row), their topics those of
    the row before them."""
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
    if dead:
        p_tok = torch.where(p_tok >= P - dead, P, p_tok).to(torch.int32)
        sel_k[-dead:] = sel_k[-dead - 1]
        phi_pack[-dead:] = 0.0
    return [p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k]


def selected_mask(mu, p_tok, sel_k, P):
    """True at each power token's selected topics: what a sweep may change."""
    import torch

    sel = torch.zeros_like(mu, dtype=torch.bool)
    rows = (p_tok < P).nonzero().squeeze(1)
    sel[rows[:, None], sel_k.long()[p_tok.long()[rows]]] = True
    return sel


def check_packed_sweep(packed, gen, *, D, L, K, P, Pk, guard_share,
                       empty_doc, timed, skewed=False, dead=0):
    """The packed sweep against its plain version: mu', theta_delta, d_pack
    and r_pack at rel 1e-5 (max |gap| over max |plain|); every coordinate
    outside the power tokens' selections bit for bit as it was; a second
    launch on the same inputs repeats all four outputs bit for bit.  The
    kernel gets its sweep order made beforehand, as the training step makes
    it once per mini-batch.  With ``dead`` dead slots, their d/r must be
    exactly 0."""
    import torch

    from repro_torch.kernels.token_order import sweep_order

    x = packed_inputs(gen, D=D, L=L, K=K, P=P, Pk=Pk,
                      guard_share=guard_share, empty_doc=empty_doc,
                      skewed=skewed, dead=dead)
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
    zero = not dead or not (got[2][-dead:].any() or got[3][-dead:].any())
    tag = (" skewed" if skewed else "") + (f" dead slots={dead}" if dead
                                           else "")
    print(f"[kernel] power_sweep_tokens{tag} T={D * L} D={D} K={K} P={P} "
          f"Pk={Pk} guard={guard_share}: rel mu'={rel[0]:.3e}  rel dtheta="
          f"{rel[1]:.3e}  rel d_pack={rel[2]:.3e}  rel r_pack={rel[3]:.3e} "
          f"(tol 1e-5)  untouched bit for bit: {kept}  relaunch bit for bit: "
          f"{same}" + (f"  dead slots' d/r exactly 0: {zero}" if dead
                       else ""))
    if not (max(rel) <= 1e-5 and kept and same and zero):
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


def check_pack_rows(pack_ops, gen, *, W, K, P, Pk, outside, timed,
                    dead=0):
    """The phi pack against its plain version, exactly; with ``outside``,
    a column and a row outside the matrix pack to 0; with ``dead``, the
    last ``dead`` slots repeat one all-zero row (`dead_slots`) and pack to
    0."""
    import torch

    dev = "cuda"
    mat = torch.rand((W, K), generator=gen, device=dev) * 4
    perm = torch.randperm(W, generator=gen, device=dev).to(torch.int32)
    sel_w = perm[:P].clone()
    sel_k = torch.rand((P, K), generator=gen, device=dev).argsort(dim=1)[
        :, :Pk].to(torch.int32).contiguous()
    if outside:
        sel_k[0, 0] = K
        sel_w[1] = W
    if dead:
        dead_slots(sel_w, sel_k, dead, int(perm[P]))
        mat[int(perm[P])] = 0.0
    got = pack_ops.pack_rows(mat, sel_w, sel_k)
    want = pack_ops.pack_rows_plain(mat, sel_w, sel_k)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    zeros = not outside or (float(got[0, 0]) == 0.0
                            and not bool(got[1].any()))
    zeros &= not dead or not bool(got[-dead:].any())
    print(f"[kernel] pack_rows W={W} K={K} P={P} Pk={Pk}: max|dout|="
          f"{err:.3e} (exact)" + ("  outside pairs 0: " + str(zeros)
                                  if outside else "")
          + (f"  dead slots={dead} packed 0: {zeros}" if dead else ""))
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
            "topic_sum": sweeps, "gibbs_sweep": 0, "gibbs_noise": 0,
            "power_topics": sweeps}
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


def repeat_step(step, state, mb, tag: str, card: str, live_w=None) -> None:
    """One mini-batch run twice from one state, the generator's state put
    back in between: phi_acc, theta, mean_r and iterations must be equal
    bit for bit (every sum of the step runs in a fixed order).  ``live_w``
    is the live-W step's trailing argument."""
    import torch

    rng = state.generator.get_state()
    live = () if live_w is None else (live_w,)
    runs = []
    for _ in range(2):
        state.generator.set_state(rng)
        torch.cuda.synchronize()
        t0 = time.time()
        new, diag = step(state, mb.word_ids, mb.counts, *live)
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
                  "word_rows_sum", "topic_sum", "power_topics")


def driver_args(ckpt_dir, *, seed: int, docs: int, extra=()):
    """The driver's flags at PUBMED width with the paper-scale settings:
    one shard, 4 mini-batches of ``docs`` documents (length mean 128, one
    bucket of 128), a checkpoint every 2; ``extra`` flags override."""
    from repro_torch.launch import lda_train

    return lda_train.build_parser().parse_args([
        "--vocab", "141043", "--topics", "2000", "--lambda-w", "0.1",
        "--lambda-k", "50", "--inner-iters", "200", "--tol", "0.1",
        "--docs-per-batch", str(docs), "--doc-len-means", "128",
        "--len-buckets", "128", "--minibatches", "4", "--ckpt-every", "2",
        "--log-every", "0", "--seed", str(seed), "--device", "cuda",
        "--shards", "1", "--ckpt-dir", str(ckpt_dir), *extra])


def timed_driver(args, walls: list, io: dict, every: bool = False):
    """``lda_train.train_loop(args)`` with each step of the run's stream
    timed (host clock, ended by a device sync; the first step built is the
    run's, and its last calls are the stream's) and the checkpoint saves
    and restores timed into ``io`` (seconds).  With ``every`` (a dynamic
    run builds a step a rung) every step built is timed, and only the
    stream's calls are kept (the warm-up's pass live_w 1 or W_cap - 1)."""
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
        if built and not every:
            return step, meter
        built.append(step)
        warm_live = (1, a[0].vocab_size - 1)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = step(*sa, **skw)
            torch.cuda.synchronize()
            if not every or sa[3:4] and sa[3] not in warm_live:
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
    The checkpoints live in a directory deleted at the end.  Returns (a)'s
    launches net of its warm-up, its result and its warmed step walls."""
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
    return net, res_a, steps


# --------------------------------------------------------------- phase 9

SIM_SHARDS = 4


def sim_slice(batches, *, W: int, K: int, seed: int, card: str,
              single_readings, device="cuda"):
    """Phase 9 (a): ``make_train_step(cfg, 4)``, four data shards in
    lockstep on the card, over phase 6's mini-batches split 4 x D/4
    documents, with phase 6's settings.  Checks: each training kernel
    launched 4 x its single-shard count for the iterations run; phi_acc
    holding every token (rel 1e-4), finite; the meter's dense and power
    bytes Eq. 5/6's (2 W K 4 and 2 P Pk 4) and ``per_minibatch_bytes``
    following from them; one mini-batch twice from one state equal bit for
    bit; the four shards' phi_acc identical bit for bit
    (``make_sim_minibatch_fn``).  Prints the step walls and ms per
    iteration beside phase 6's single-shard steps on the same documents,
    the peak device memory, and one step profiled (the card's busy
    share).  Returns (launch counts, readings)."""
    import torch

    from repro_torch.core.pobp import (init_train_state, make_sim_minibatch_fn,
                                       make_train_step)
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.batching import stack_shards
    from repro_torch.kernels import launch_counts

    N = SIM_SHARDS
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_w=0.1,
                    lambda_k_abs=50, inner_iters=200, residual_tol=0.1)
    step, meter = make_train_step(cfg, N, device=device)
    state = init_train_state(cfg, seed, device=device)
    stacked = [stack_shards(mb, N) for mb in batches]
    card_ = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if card_ else (lambda: None)
    if card_:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    readings, tokens = [], 0.0
    sync()
    launch_counts(reset=True)                    # the main path starts here
    for mb in stacked:
        t0 = time.time()
        state, diag = step(state, mb.word_ids, mb.counts)
        mean_r = float(diag["mean_r"])
        sync()
        wall = time.time() - t0
        ntok = float(mb.counts.sum())
        tokens += ntok
        readings.append((wall, diag["iters"], ntok, mean_r))
    launches = launch_counts()                   # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30 if card_ else 0.0

    for i, ((wall, iters, ntok, mean_r), one) in enumerate(
            zip(readings, single_readings)):
        print(f"[sim] step {i + 1}: {N} shards {wall * 1e3:.3f} ms  "
              f"iters={iters}  {wall * 1e3 / iters:.3f} ms/iteration  "
              f"{ntok / wall:.1f} tokens/s  mean_r={mean_r:.4f}; one shard "
              f"(phase 6) {one[0] * 1e3:.3f} ms  iters={one[1]}  "
              f"{one[0] * 1e3 / one[1]:.3f} ms/iteration  [{card}]")
    print(f"[sim] peak device memory {peak:.2f} GiB  [{card}]")
    sweeps = sum(iters - 1 for _, iters, _, _ in readings)
    want = {"bp_update": N * len(batches), "power_sweep_carry": 0,
            "power_sweep_carry_train": N * sweeps,
            "scatter_add_rows": N * sweeps, "power_sweep_tokens": 0,
            "pack_rows": 0, "word_rows_sum": N * 3 * len(batches),
            "topic_sum": N * sweeps, "gibbs_sweep": 0, "gibbs_noise": 0,
            "power_topics": N * sweeps}
    print(f"[sim] launches {launches} ({N} x the single-shard counts of "
          f"{len(batches)} steps and {sweeps} selective sweeps)")
    if launches != want:
        fail(f"the 4-shard simulation launched {launches}, expected {want}")
    mass = float(state.phi_acc.sum(dtype=torch.float64))
    print(f"[sim] phi_acc mass {mass:.3f} against {tokens:.0f} tokens "
          f"(rel {abs(mass - tokens) / tokens:.2e}, tol 1e-4)")
    if not (abs(mass - tokens) <= 1e-4 * tokens
            and bool(torch.isfinite(state.phi_acc).all())):
        fail("the 4-shard phi_acc does not hold its tokens or is not finite")
    P, Pk = cfg.num_power_words, cfg.num_power_topics
    by = meter.bytes_by_phase
    want_by = {"tokens": 4, "dense": 2 * W * K * 4, "power": 2 * P * Pk * 4}
    per = {it: meter.per_minibatch_bytes(it) for _, it, _, _ in readings}
    print(f"[sim] meter {by}; per-minibatch bytes by iterations {per} "
          f"(Eq. 5: dense 2 W K 4 = {2 * W * K * 4:,}; Eq. 6: power "
          f"2 P Pk 4 = {2 * P * Pk * 4:,})")
    if by != want_by or any(v != 4 + 2 * W * K * 4 + (it - 1) * 2 * P * Pk * 4
                            for it, v in per.items()):
        fail("the 4-shard meter does not follow Eq. 5/6")
    repeat_step(step, state, stacked[1 % len(stacked)], "sim", card)
    if card_:
        (_, diag), _ = profile_run(
            lambda: step(state, stacked[0].word_ids, stacked[0].counts),
            f"one {N}-shard step (batch 1 again)", card,
            watch=("carry_train_kernel", "bp_update"))
        print(f"[profile] that step ran {diag['iters']} iterations")
        del diag
    del step
    fn, _ = make_sim_minibatch_fn(cfg, N, device=device)
    mb = stacked[1 % len(stacked)]
    phi, iters, *_ = fn(mb.word_ids, mb.counts, state.phi_acc, 1.0,
                        generator=torch.Generator(device=device).manual_seed(
                            seed + 3))
    same = all(bool(torch.equal(phi[n], phi[0])) for n in range(1, N))
    print(f"[sim] one mini-batch through make_sim_minibatch_fn: the {N} "
          f"shards' phi_acc identical bit for bit: {same}  iters "
          f"{iters.tolist()}")
    if not same or len(set(iters.tolist())) != 1:
        fail("the shards of the simulation disagree")
    del phi, state
    return launches, readings


def mesh_slice(*, seed: int, docs: int, card: str):
    """Phase 9 (b): the driver's ``--backend shard_map`` at PUBMED width
    with phase 8's settings, 2 mini-batches of ``docs`` documents.  (1) A
    2 x 2 mesh (documents over 2 data shards, topics over 2) of four gloo
    ranks on the one card: every rank ends with the same iterations and
    mean_r; rank 0's checkpoint holds a global [W, K] phi_acc, finite,
    holding every token; the [comm] phases carry ``model_norm``,
    ``model_rw`` and ``model_rw_loop``.  (2) A 1 x 1 NCCL mesh equal to
    ``--backend sim --shards 1`` bit for bit (mean_r, iterations,
    phi_acc).  (3) A 2 x 2 NCCL mesh where the card count allows.  The
    ranks' kernel launches are printed."""
    import torch

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import lda_train

    print("[mesh] with 2 topic shards the dense sweep runs the reference's "
          "formulation in torch code, its normalizer psum'd over the topic "
          "shards (bp_update normalizes over all of K); every other kernel "
          "of the path runs in every rank; the 1x1 mesh runs bp_update")
    root = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    grid = ("--backend", "shard_map", "--minibatches", "2")
    try:
        t0 = time.time()
        res = lda_train.train_loop(driver_args(
            root / "grid", seed=seed, docs=docs,
            extra=grid + ("--mesh-shape", "2,2", "--dist-backend", "gloo")))
        wall = time.time() - t0
        agree = all(r["iters"] == res["iters"] and r["mean_r"] == res["mean_r"]
                    for r in res["ranks"])
        phi, _, step = ckpt.restore_phi(str(root / "grid"))
        mass = float(phi.double().sum())
        finite = bool(torch.isfinite(phi).all())
        by = res["bytes_by_phase"]
        print(f"[mesh] 2x2 gloo, 4 ranks on one card, {wall:.1f}s (warm-up "
              f"{res['warmup_s']:.1f}s, stream {res['wall_s']:.2f}s): iters "
              f"{res['iters']}  mean_r {res['mean_r']}; every rank alike: "
              f"{agree}  [{card}]")
        print(f"[mesh] rank 0's checkpoint (step {step}): phi_acc "
              f"{tuple(phi.shape)} finite {finite}, mass {mass:.3f} against "
              f"{res['tokens']:.0f} tokens; [comm] per-minibatch bytes="
              f"{res['per_minibatch_bytes']:,} (phases: {by})")
        print(f"[mesh] ranks' kernel launches: "
              f"{[{k: n for k, n in r['launches'].items() if n} for r in res['ranks']]}")
        if not (agree and finite and tuple(phi.shape) == (141043, 2000)
                and abs(mass - res["tokens"]) <= 1e-4 * res["tokens"]
                and {"model_norm", "model_rw", "model_rw_loop"} <= set(by)):
            fail("the 2x2 gloo mesh's ranks disagree, or its checkpoint or "
                 "meter is wrong")
        del phi

        sim = lda_train.train_loop(driver_args(
            root / "sim", seed=seed, docs=docs, extra=("--minibatches", "2")))
        one = lda_train.train_loop(driver_args(
            root / "one", seed=seed, docs=docs,
            extra=grid + ("--mesh-shape", "1,1", "--dist-backend", "nccl")))
        same = {"mean_r": one["mean_r"] == sim["mean_r"],
                "iters": one["iters"] == sim["iters"],
                "phi_acc": bool(torch.equal(one["phi_acc"], sim["phi_acc"]))}
        print(f"[mesh] 1x1 nccl against --backend sim --shards 1: mean_r "
              f"{one['mean_r']} / {sim['mean_r']}, iters {one['iters']} / "
              f"{sim['iters']}; equal bit for bit: {same}; the rank's "
              f"launches {one['ranks'][0]['launches']}")
        if not all(same.values()):
            fail("the 1x1 NCCL mesh differs from the one-shard simulation")
        cards = torch.cuda.device_count()
        if cards >= 4:
            nccl = lda_train.train_loop(driver_args(
                root / "nccl", seed=seed, docs=docs,
                extra=grid + ("--mesh-shape", "2,2", "--dist-backend",
                              "nccl")))
            print(f"[mesh] 2x2 nccl on {cards} cards: iters "
                  f"{nccl['iters']}, mean_r {nccl['mean_r']}")
        else:
            print(f"[mesh] 2x2 nccl not run: {cards} card(s), NCCL takes a "
                  f"card a rank")
        del sim, one
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sharded_serve(ckpt_dir: Path, docs, *, seed: int, card: str,
                  phase3_dps: float, device="cuda"):
    """Phase 9 (c): ``SlabEngine(topic_shards=4)`` from phase 3's checkpoint
    (phi [4, W', K/4] on the card, the sharded body in torch code) and the
    unsharded engine, each serving ``docs`` with one seed: every theta
    finite, summing to 1 +- 1e-5, the sharded within 1e-5 of the
    unsharded; the model psums billed per retired document
    (``comm_bytes`` > 0, the slab's per-sweep normalizer phase
    ``slab_norm_loop`` in the meter).  Prints docs/s beside phase 3's."""
    import numpy as np

    from repro_torch.serve import SlabEngine

    print("[shard-serve] the topic-sharded body runs torch code, not the "
          "serving kernel (which needs every topic of a row), as the "
          "reference's jnp path does")
    out = {}
    for shards in (1, 4):
        eng = SlabEngine.from_checkpoint(str(ckpt_dir), seed=seed,
                                         topic_shards=shards, device=device)
        results, wall = serve_burst(eng, docs)
        out[shards] = ({r.req_id: r for r in results}, wall, eng.stats())
        del eng
    (solo, wall1, _), (shard, wall4, s4) = out[1], out[4]
    th1 = np.stack([solo[i].theta for i in sorted(solo)])
    th4 = np.stack([shard[i].theta for i in sorted(shard)])
    gap = float(np.abs(th4 - th1).max())
    sums = float(np.abs(th4.sum(axis=1) - 1.0).max())
    billed = [shard[i].comm_bytes for i in sorted(shard)]
    print(f"[shard-serve] {len(shard)} requests, 4 topic shards: max "
          f"|theta - unsharded| {gap:.3e} (tol 1e-5), sums within "
          f"{sums:.2e} of 1; comm bytes a document {min(billed):,.0f}.."
          f"{max(billed):,.0f} (mean {s4['per_request_bytes']:,.0f}); meter "
          f"{s4['bytes_by_phase']}")
    print(f"[shard-serve] {len(shard) / wall4:.1f} docs/s sharded, "
          f"{len(solo) / wall1:.1f} unsharded (phase 3's first burst: "
          f"{phase3_dps:.1f})  [{card}]")
    if not (np.isfinite(th4).all() and sums <= 1e-5 and gap <= 1e-5
            and min(billed) > 0
            and s4["bytes_by_phase"].get("slab_norm_loop", 0) > 0):
        fail("topic-sharded serving disagrees with the unsharded engine or "
             "bills nothing")


# --------------------------------------------------------------- phase 10

def lifecycle_args(ckpt_dir, *, seed: int, docs: int, extra=(), W=141043,
                   K=2000, device="cuda"):
    """Phase 8's flags (PUBMED width, the paper-scale settings, one shard,
    4 mini-batches of ``docs`` documents, a checkpoint every 2) with
    ``--dynamic-vocab``: the drifting stream over PUBMED's W = 141,043
    external words; ``extra`` flags override."""
    return driver_args(ckpt_dir, seed=seed, docs=docs,
                       extra=("--dynamic-vocab", "--vocab", str(W),
                              "--topics", str(K), "--device", device,
                              *extra))


def stream_walls(walls) -> str:
    return ", ".join(f"{w * 1e3:.3f}" for w in walls)


def expect_crash(args) -> None:
    try:
        timed_driver(args, [], {})
    except SystemExit as e:
        print(f"[lifecycle] {e}")
    else:
        fail("--crash-at 3 did not end the run")


@contextlib.contextmanager
def drawn_once():
    """While open, each batch of the drifting streams (``data/synthetic``'s
    ``drifting_vocab_docs`` and ``drifting_news_stream``, pure functions of
    their arguments) is drawn on the host once and handed out again as a
    copy to every later run that asks for it: phase 10's runs read the
    same batches, and a draw at PUBMED width takes seconds."""
    import copy

    from repro_torch.data import synthetic

    real = {name: getattr(synthetic, name)
            for name in ("drifting_vocab_docs", "drifting_news_stream")}
    drawn: dict = {}

    def once(name):
        def draw(*args, score_cache=None, **kw):
            key = (name, args, tuple(sorted(kw.items())))
            if key not in drawn:
                drawn[key] = real[name](*args, score_cache=score_cache, **kw)
            return copy.deepcopy(drawn[key])
        return draw

    try:
        for name in real:
            setattr(synthetic, name, once(name))
        yield drawn
    finally:
        for name, fn in real.items():
            setattr(synthetic, name, fn)


def lifecycle_slice(*, seed: int, docs: int, card: str, W=141043, K=2000,
                    drift=8192, rung=131072, device="cuda"):
    """Phase 10: the driver's dynamic vocabulary and stream lifecycle on the
    card at PUBMED width (K = 2000, phase 8's settings; depth cut, width
    not).  (a) grow: 4 mini-batches of ``docs`` documents over 141,043
    external words, a checkpoint every 2: at least two growth events, the
    last to a rung >= 131,072; every training kernel launched (net of the
    warm-ups); phi_acc finite, its guard rows exactly 0, every consumed
    token held (rel 1e-4); one live-W mini-batch twice from one state, bit
    for bit.  (b) ``--crash-at 3`` in a fresh directory, then again: it
    resumes at m = 2, past the second growth, and ends equal to (a) bit for
    bit (mean_r, iterations, phi_acc, rung, keys).  (c) 2 mini-batches, 8
    iterations each, grown from the first rung and fresh at the grown run's
    final rung: no growth in the fresh run, the same keys, mean_r and
    phi_acc[:live_w] within rtol 1e-6.  (d) the sliding stream with decay
    and a fence every 2: at least one fence reclaims rows; a fence that
    drops a rung frees the old rung's bytes (and a direct shrink of a
    131,072 x 2000 state frees them); ``--crash-at 3`` then again, equal to
    the uninterrupted run bit for bit (with the same vocabulary version,
    touch stamps and row remap); 64 requests served in float32 by
    ``SlabEngine.from_checkpoint`` from the last post-compaction
    checkpoint, each theta finite and summing to 1 +- 1e-5, unseen keys on
    the guard row, the vocabulary unchanged.  Returns (a)'s launches net of
    its warm-ups.  (The keywords shrink it for a rehearsal.)"""
    import numpy as np
    import torch

    from repro_torch.core.lifecycle import resize_state
    from repro_torch.core.pobp import make_train_step
    from repro_torch.core.types import LDATrainState
    from repro_torch.data import synthetic
    from repro_torch.data.vocab import VocabMap
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import lda_train
    from repro_torch.serve import SlabEngine

    args_at = functools.partial(lifecycle_args, seed=seed, docs=docs, W=W,
                                K=K, device=device)
    slide = ("--drift-mode", "slide", "--vocab-growth-per-batch", str(drift),
             "--decay", "1,0.5", "--compact-every", "2",
             "--compact-min-idle", "1", "--compact-mass-tol", "25",
             "--recycle-tol", "0.01", "--minibatches", "4",
             "--ckpt-every", "2")
    root = ROOT / "build" / "chip_smoke_lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    try:
        # the host draws: every word's topic scores (once a process, for
        # both streams), then one batch (its window's cdf and documents)
        t0 = time.time()
        cache = lda_train._score_cache(seed, K)
        words = W + 3 * drift                       # (d)'s last window
        synthetic._scores_upto(cache, seed, K, words)
        print(f"[lifecycle] word scores ({words} x {K} gamma draws on the "
              f"host, in worker processes) in {time.time() - t0:.1f}s")
        t0 = time.time()
        synthetic.drifting_vocab_docs(seed, 0, docs, W, K,
                                      doc_len_mean=128, score_cache=cache)
        print(f"[lifecycle] one host draw of {docs} documents over {W} "
              f"words (the window's cdf, then the documents) in "
              f"{time.time() - t0:.2f}s")

        # ---- (a) grow
        t0 = time.time()
        a_args = args_at(root / "a")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        walls, io = [], {}
        res_a = timed_driver(a_args, walls, io, every=True)
        counts = launch_counts()
        net = {k: counts[k] - res_a["warmup_launches"].get(k, 0)
               for k in counts}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ev, live = res_a["growth_events"], res_a["live_w"]
        phi = res_a["phi_acc"]
        held = abs(float(phi.double().sum()) - res_a["tokens"]) / \
            res_a["tokens"]
        print(f"[lifecycle] (a) grow: {len(res_a['iters'])} mini-batches in "
              f"{time.time() - t0:.1f}s; growth events {ev} "
              f"({res_a['growth_s']:.2f}s: resize, rebuild, rewarm, save); "
              f"live_w {live} W_cap {res_a['w_cap']}; mean_r "
              f"{res_a['mean_r']}  iters {res_a['iters']}  "
              f"{res_a['tokens']:.0f} tokens (held to rel {held:.1e})  peak "
              f"device memory {peak:.2f} GiB  [{card}]")
        print(f"[lifecycle] (a) stream step walls (ms) {stream_walls(walls)};"
              f" saves {', '.join(f'{x:.2f}' for x in io['save_s'])} s  "
              f"[{card}]")
        print(f"[lifecycle] (a) launches net of the warm-ups {net}")
        if not (len(ev) >= 2 and ev[-1]["w_cap"] >= rung
                and res_a["w_cap"] == ev[-1]["w_cap"]):
            fail(f"the grown run did not grow twice to a rung >= {rung}: "
                 f"{ev}")
        if any(net[k] <= 0 for k in DRIVER_KERNELS):
            fail(f"the live-W run did not go through every training kernel "
                 f"(net of its warm-ups: {net})")
        if not (bool(torch.isfinite(phi).all()) and not phi[live:].any()
                and held <= 1e-4):
            fail("the grown phi_acc is not finite, its guard rows are not 0, "
                 "or it does not hold every consumed token")
        cfg, buckets = lda_train._build_cfg(a_args, vocab_size=res_a["w_cap"])
        step, _ = make_train_step(cfg, 1, device=device)
        (mb, _, live_b), = lda_train.drifting_stream(
            a_args, buckets, 3, VocabMap(res_a["vocab_keys"]), end_m=4)()
        state = LDATrainState(
            phi_acc=phi.to(device), m=4,
            generator=torch.Generator(device=device).manual_seed(seed))
        repeat_step(step, state, mb, "lifecycle", card, live_w=live_b)
        del step, state, mb

        # ---- (b) crash-resume across the growth events
        t0 = time.time()
        b_args = args_at(root / "b", extra=("--crash-at", "3"))
        expect_crash(b_args)
        res_b = timed_driver(b_args, [], {})
        same = {k: res_b[k] == res_a[k] for k in ("w_cap", "vocab_keys")}
        same.update(first_m=res_b["first_m"] == 2,
                    mean_r=res_b["mean_r"] == res_a["mean_r"][2:],
                    iters=res_b["iters"] == res_a["iters"][2:],
                    phi_acc=bool(torch.equal(res_b["phi_acc"], phi)))
        print(f"[lifecycle] (b) resumed at m={res_b['first_m']} on W_cap "
              f"{res_b['w_cap']} (growth events before the crash: "
              f"{[e['m'] for e in ev if e['m'] < 3]}); equal to (a) bit for "
              f"bit: {same}  ({time.time() - t0:.1f}s)")
        if not all(same.values()):
            fail("the resumed lifecycle run differs from the uninterrupted "
                 "run")
        del res_b

        # ---- (c) grown against fresh at the final rung
        t0 = time.time()
        c_extra = ("--minibatches", "2", "--inner-iters", "8", "--tol",
                   "1e-9", "--ckpt-every", "0")
        grown = timed_driver(args_at(root / "c1", extra=c_extra), [], {})
        fresh = timed_driver(args_at(
            root / "c2", extra=c_extra + ("--w-cap-min", str(grown["w_cap"]))),
            [], {})
        lw = grown["live_w"]
        gap_r = max(abs(a - b) / abs(b) for a, b in
                    zip(fresh["mean_r"], grown["mean_r"]))
        gp, fp = grown["phi_acc"][:lw], fresh["phi_acc"][:lw]
        close = bool(torch.allclose(fp, gp, rtol=1e-6, atol=1e-7))
        print(f"[lifecycle] (c) grown {grown['growth_events']} against fresh "
              f"at W_cap {fresh['w_cap']} ({fresh['growth_events']}): keys "
              f"equal {fresh['vocab_keys'] == grown['vocab_keys']}; iters "
              f"{grown['iters']} / {fresh['iters']}; max rel mean_r gap "
              f"{gap_r:.2e}; phi_acc[:{lw}] max |gap| "
              f"{float((fp - gp).abs().max()):.3e}, within rtol 1e-6 atol "
              f"1e-7: {close}, bit for bit: {bool(torch.equal(fp, gp))}  "
              f"({time.time() - t0:.1f}s)  [{card}]")
        if not (fresh["growth_events"] == [] and close and gap_r <= 1e-6
                and fresh["vocab_keys"] == grown["vocab_keys"]
                and fresh["iters"] == grown["iters"]):
            fail("the grown run and the fresh run at its final rung differ")
        del grown, fresh, gp, fp

        # ---- (d) the sliding stream with the lifecycle
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        d_walls = []
        res_d = timed_driver(args_at(root / "d", extra=slide), d_walls, {},
                             every=True)
        peak_d = torch.cuda.max_memory_allocated() / 2**30
        print(f"[lifecycle] (d) slide: {len(res_d['iters'])} mini-batches in "
              f"{time.time() - t0:.1f}s (--compact-mass-tol 25: a floor of "
              f"25 x K x beta = 500); growth events "
              f"{res_d['growth_events']} ({res_d['growth_s']:.2f}s); "
              f"compactions {res_d['compaction_events']} "
              f"({res_d['compact_s']:.2f}s); occupancy "
              f"{res_d['occupancy_trace']}; vocab_version "
              f"{res_d['vocab_version']}; iters {res_d['iters']}; peak "
              f"device memory {peak_d:.2f} GiB  [{card}]")
        print(f"[lifecycle] (d) stream step walls (ms) "
              f"{stream_walls(d_walls)}  [{card}]")
        if not any(e["dead"] > 0 for e in res_d["compaction_events"]):
            fail("no compaction fence reclaimed a row")
        phi_d = res_d["phi_acc"]
        if not (bool(torch.isfinite(phi_d).all())
                and not phi_d[res_d["live_w"]:].any()):
            fail("the lifecycle run's phi_acc is not finite or its guard rows "
                 "are not 0")
        drops = [f for f in res_d["fence_bytes"] if f["w_cap"][1] <
                 f["w_cap"][0]]
        for f in res_d["fence_bytes"]:
            (c0, c1), (b0, b1) = f["w_cap"], f["allocated"]
            print(f"[lifecycle] (d) fence at m={f['m']}: W_cap {c0} -> {c1}, "
                  f"device memory allocated {b0 / 2**20:.1f} -> "
                  f"{b1 / 2**20:.1f} MiB (the rung's rows "
                  f"{(c0 - c1) * K * 4 / 2**20:.1f} MiB)")
        if not drops:
            print("[lifecycle] (d) no fence dropped a rung")
        for f in drops:
            (c0, c1), (b0, b1) = f["w_cap"], f["allocated"]
            if b0 - b1 < 0.99 * (c0 - c1) * K * 4:
                fail(f"the fence at m={f['m']} dropped the rung {c0} -> {c1} "
                     f"but freed only {(b0 - b1) / 2**20:.1f} MiB")
        st = LDATrainState(
            phi_acc=torch.zeros((rung, K), device=device), m=0,
            generator=torch.Generator(device=device))
        before = torch.cuda.memory_allocated()
        st = resize_state(st, rung // 2, live_w=rung // 2 - 1)
        freed = before - torch.cuda.memory_allocated()
        print(f"[lifecycle] (d) a direct shrink of a {rung} x {K} state to "
              f"{rung // 2} rows freed {freed / 2**20:.1f} MiB (the rows "
              f"cut: {rung // 2 * K * 4 / 2**20:.1f} MiB)")
        if freed < 0.99 * rung // 2 * K * 4:
            fail("a shrink did not free the old rung's storage")
        del st

        t0 = time.time()
        e_args = args_at(root / "e", extra=slide + ("--crash-at", "3"))
        expect_crash(e_args)
        res_e = timed_driver(e_args, [], {})
        first = res_e["first_m"]
        dyn_d = ckpt.peek_extra(str(root / "d"))[0]["dyn"]
        dyn_e = ckpt.peek_extra(str(root / "e"))[0]["dyn"]
        same = {k: res_e[k] == res_d[k] for k in ("vocab_keys",
                                                  "vocab_version", "w_cap")}
        same["compaction_events"] = res_e["compaction_events"] == [
            e for e in res_d["compaction_events"] if e["m"] > first]
        same.update(mean_r=res_e["mean_r"] == res_d["mean_r"][first:],
                    iters=res_e["iters"] == res_d["iters"][first:],
                    phi_acc=bool(torch.equal(res_e["phi_acc"], phi_d)),
                    **{k: dyn_e[k] == dyn_d[k] for k in ("row_remap",
                                                         "touched")})
        print(f"[lifecycle] (d) --crash-at 3 then again: resumed at m={first}"
              f" (after the fence at 2), through the fence at 4; equal "
              f"to the uninterrupted run bit for bit: {same}  "
              f"({time.time() - t0:.1f}s)")
        if not (first == 2 and all(same.values())):
            fail("the lifecycle run resumed across a fence differs")
        del res_e

        t0 = time.time()
        eng = SlabEngine.from_checkpoint(str(root / "d"), device=device)
        n_keys = len(eng._vocab)
        reqs, _ = synthetic.drifting_news_stream(
            seed, 3, 64, W, drift, K, doc_len_mean=128, heldout=True,
            score_cache=cache)
        for doc in reqs:
            eng.submit(doc)
        out = eng.drain()
        th = np.stack([np.asarray(r.theta) for r in out])
        dev1 = float(np.abs(th.sum(1) - 1).max())
        oov = eng.stats()["oov_rate"]
        print(f"[lifecycle] (d) served {len(out)} requests in "
              f"{eng._phi.dtype} from the post-compaction checkpoint (step "
              f"{ckpt.latest_step(str(root / 'd'))}, live_w "
              f"{dyn_d['live_w']}, W_cap {dyn_d['w_cap']}): theta finite, "
              f"sums within {dev1:.2e} of 1 (tol 1e-5); OOV rate {oov:.4f} "
              f"on the guard row {eng._oov_row}; vocabulary {n_keys} -> "
              f"{len(eng._vocab)} keys  ({time.time() - t0:.1f}s)")
        if not (len(out) == 64 and bool(np.isfinite(th).all())
                and dev1 <= 1e-5 and eng._phi.dtype == torch.float32
                and eng._oov_row == dyn_d["live_w"] and oov > 0
                and len(eng._vocab) == n_keys):
            fail("serving from the post-compaction checkpoint failed")
        del eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return net


def recycle_slice(*, seed: int, docs: int, card: str, W=20000, K=2000,
                  drift=2048, device="cuda"):
    """Phase 10 (e): topic recycling on the card at a reduced width (W =
    20,000, K = 2000, phase 8's settings): the sliding stream with decay, a
    fence every 2 of 4 mini-batches and ``--recycle-tol 1`` (every topic at
    or under the mean topic mass), in float32 and in bf16 phi_acc.  Each
    fence must recycle topics (phi_acc to the host and back to the card in
    its storage dtype); ``--crash-at 3`` then again resumes from the
    recycling fence at 2 and must end equal to the uninterrupted run bit
    for bit (mean_r, iterations, phi_acc, keys, the later fences'
    recycled topics).  (The keywords shrink it for a rehearsal.)"""
    import torch

    root = ROOT / "build" / "chip_smoke_recycle"
    shutil.rmtree(root, ignore_errors=True)
    flags = ("--drift-mode", "slide", "--vocab-growth-per-batch", str(drift),
             "--decay", "1,0.5", "--compact-every", "2",
             "--compact-min-idle", "1", "--compact-mass-tol", "25",
             "--recycle-tol", "1.0", "--minibatches", "4", "--ckpt-every",
             "2")
    try:
        for dtype in ("float32", "bfloat16"):
            t0 = time.time()
            extra = flags + ("--phi-acc-dtype", dtype)
            full = timed_driver(lifecycle_args(
                root / f"{dtype}_a", seed=seed, docs=docs, W=W, K=K,
                device=device, extra=extra), [], {}, every=True)
            ev = full["compaction_events"]
            phi = full["phi_acc"]
            print(f"[recycle] (e) {dtype}: {len(full['iters'])} mini-batches "
                  f"at W={W} K={K} in {time.time() - t0:.1f}s; fences "
                  + "; ".join(f"m={e['m']}: {len(e['recycled'])} topics "
                              f"recycled, {e['dead']} rows reclaimed"
                              for e in ev)
                  + f"; fences {full['compact_s']:.2f}s; phi_acc "
                  f"{phi.dtype}  [{card}]")
            if not (len(ev) == 2 and all(e["recycled"] for e in ev)
                    and phi.dtype == getattr(torch, dtype)
                    and bool(torch.isfinite(phi).all())):
                fail(f"a {dtype} fence did not recycle, or phi_acc left the "
                     f"storage dtype or is not finite: {ev}")
            t0 = time.time()
            b_args = lifecycle_args(root / f"{dtype}_b", seed=seed,
                                    docs=docs, W=W, K=K, device=device,
                                    extra=extra + ("--crash-at", "3"))
            expect_crash(b_args)
            res = timed_driver(b_args, [], {})
            same = {"first_m": res["first_m"] == 2,
                    "mean_r": res["mean_r"] == full["mean_r"][2:],
                    "iters": res["iters"] == full["iters"][2:],
                    "phi_acc": bool(torch.equal(res["phi_acc"], phi)),
                    "vocab_keys": res["vocab_keys"] == full["vocab_keys"],
                    "recycled": res["compaction_events"] == ev[1:]}
            print(f"[recycle] (e) {dtype} --crash-at 3 then again: resumed "
                  f"at m={res['first_m']} from the recycling fence, equal to "
                  f"the uninterrupted run bit for bit: {same}  "
                  f"({time.time() - t0:.1f}s)")
            if not all(same.values()):
                fail(f"the {dtype} run resumed across a recycling fence "
                     f"differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------- phase 11

# one direction of the host link: PCIe Gen5 x16 (NVIDIA's H100 SXM data
# sheet gives 128 GB/s for both directions together)
PCIE_BYTES_PER_S = 64e9


def ps_args(ckpt_dir, *, seed: int, docs: int, W=141043, K=2000,
            device="cuda", extra=()):
    """Phase 8's flags (PUBMED width, the paper-scale settings, one shard,
    4 mini-batches of ``docs`` documents, a checkpoint every 2) with
    ``--backend ps --ps-servers 4 --staleness 0``; ``extra`` overrides."""
    return driver_args(ckpt_dir, seed=seed, docs=docs, extra=(
        "--vocab", str(W), "--topics", str(K), "--device", device,
        "--backend", "ps", "--ps-servers", "4", "--staleness", "0",
        "--ps-pull-timeout", "30", *extra))


def push_clock(pushes: dict):
    """A patch of ``ParamServer.apply_push`` that adds each call's seconds
    (a shard's ``np.add.at``, its checks and its lock) to ``pushes[(client,
    seq)]``: the server's time a push, over the shards it addresses."""
    import threading
    from unittest import mock

    from repro_torch.dist import paramserver

    lock = threading.Lock()
    apply = paramserver.ParamServer.apply_push

    def timed(self, server, rows, deltas, client_id=None, seq=None,
              replay=False):
        t0 = time.perf_counter()
        out = apply(self, server, rows, deltas, client_id=client_id,
                    seq=seq, replay=replay)
        with lock:
            key = (client_id, seq)
            pushes[key] = pushes.get(key, 0.0) + time.perf_counter() - t0
        return out

    return mock.patch.object(paramserver.ParamServer, "apply_push", timed)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def first_difference(res, base, first: int = 0):
    """The first batch whose mean_r or iterations differ, or None."""
    for i, (r, b) in enumerate(zip(zip(res["mean_r"], res["iters"]),
                                   zip(base["mean_r"][first:],
                                       base["iters"][first:]))):
        if r != b:
            return first + i + 1
    return None


def ps_slice(*, seed: int, docs: int, card: str, sim: dict, sim_walls,
             W=141043, K=2000, device="cuda"):
    """Phase 11: the parameter server through the driver on the card at
    PUBMED width (phase 8's settings, ``--backend ps --ps-servers 4``).
    (a) ``--staleness 0``: iterations equal to ``sim`` (phase 8 (a), the
    same flags under ``--backend sim``) batch by batch, phi_acc within a
    relative L1 gap of 1e-5 and mean_r within 1e-6 of it; the training
    kernels launched as often as its steps and iterations (net of the
    warm-up); every token held (rel 1e-4); the measured wire bytes (2 x
    touched rows x (K x 4 + 4) a batch, exactly) beside the meter's
    touched-row model and ``touched_power_sync_bytes`` at the measured mean
    touched rows.  (b) (a) under ``--chaos-seed 7 --chaos-drop 0.25
    --chaos-dup 0.25 --chaos-crash 1@2 --chaos-restart-after 1`` (shard 1
    crashes at push op 2, batch 3's first push, and restarts at the next
    op): equal to (a) bit for bit (mean_r, iterations, phi_acc), a recovery
    run, the crash, the restart and the duplicates counted.  (c) (a) with
    ``--elastic-workers w0,w1 --elastic-events join:w2@1,leave:w0@2,
    crash:w2@3`` (w2 is batch 3's worker: a survivor replays the batch):
    equal to (a) bit for bit.  (d) ``--crash-at 3`` then again: it resumes
    at m = 2 and ends equal to (a) bit for bit; otherwise the first batch
    that differs is named.  (e) ``--staleness 1 --ps-latency 0.001``:
    finite, every token held, its pull and push waits beside (a)'s.  (f)
    (a)'s timings: per batch the touched rows and the replica's two copies
    (CUDA events; GB/s and the PCIe bound), the server's ``np.add.at`` a
    push, the step walls beside ``sim_walls`` (phase 8 (a)'s), with
    medians.  Returns (a)'s launches net of its warm-up.  (The keywords
    shrink it for a rehearsal.)"""
    import torch

    from repro_torch.core.sync import touched_power_sync_bytes
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import lda_train

    args_at = functools.partial(ps_args, seed=seed, docs=docs, W=W, K=K,
                                device=device)
    root = ROOT / "build" / "chip_smoke_ps"
    shutil.rmtree(root, ignore_errors=True)
    try:
        # ---- (a) staleness 0 against --backend sim
        t0 = time.time()
        a_args = args_at(root / "a")
        torch.cuda.empty_cache()
        launch_counts(reset=True)
        walls, pushes = [], {}
        with push_clock(pushes):
            res_a = timed_driver(a_args, walls, {})
        counts = launch_counts()
        net = {k: counts[k] - res_a["warmup_launches"].get(k, 0)
               for k in counts}
        n, phi_a = len(res_a["iters"]), res_a["phi_acc"]
        sweeps = sum(i - 1 for i in res_a["iters"])
        want = {"bp_update": n, "power_sweep_carry_train": sweeps,
                "scatter_add_rows": sweeps, "word_rows_sum": 3 * n,
                "topic_sum": sweeps, "power_sweep_tokens": 0, "pack_rows": 0,
                "power_topics": sweeps}
        got = {k: net[k] for k in want}
        held = abs(float(phi_a.double().sum()) - res_a["tokens"]) / \
            res_a["tokens"]
        ref = sim["phi_acc"].double()
        gap_phi = float((phi_a.double() - ref).abs().sum() / ref.abs().sum())
        gap_r = max(abs(a - b) for a, b in zip(res_a["mean_r"],
                                               sim["mean_r"]))
        print(f"[ps] (a) --staleness 0: {n} mini-batches in "
              f"{time.time() - t0:.1f}s (warm-up {res_a['warmup_s']:.2f}s): "
              f"mean_r {res_a['mean_r']}  iters {res_a['iters']} (--backend "
              f"sim: {sim['iters']}); max |mean_r - sim| {gap_r:.2e} (tol "
              f"1e-6); phi_acc rel L1 gap to sim {gap_phi:.3e} (tol 1e-5); "
              f"{res_a['tokens']:.0f} tokens held to rel {held:.1e}  "
              f"[{card}]")
        print(f"[ps] (a) launches net of the warm-up {got} (steps {n}, "
              f"selective sweeps {sweeps})")
        if res_a["iters"] != sim["iters"]:
            fail(f"--backend ps ran {res_a['iters']} iterations, --backend "
                 f"sim {sim['iters']}")
        if not (gap_r <= 1e-6 and gap_phi <= 1e-5):
            fail("--backend ps at staleness 0 does not track --backend sim")
        if got != want:
            fail(f"the PS run's training kernels launched {got}, expected "
                 f"{want}")
        if not (held <= 1e-4 and bool(torch.isfinite(phi_a).all())):
            fail("the PS run's phi_acc is not finite or does not hold every "
                 "token")
        cfg, _ = lda_train._build_cfg(a_args)
        mt = res_a["mean_touched_rows"]
        touched = round(mt * n)
        P, Pk = cfg.num_power_words, min(cfg.num_power_topics, K)
        model = touched_power_sync_bytes(P, Pk, round(mt))
        by = res_a["ps_bytes_by_link"]
        pushed = sum(v for k, v in by.items() if k.startswith("push"))
        pulled = res_a["ps_wire_bytes"] - pushed
        print(f"[ps] (a) wire: {res_a['ps_wire_bytes']} B measured "
              f"({res_a['ps_wire_per_minibatch']:.0f} a mini-batch): pushed "
              f"{pushed} = {touched} touched rows x (K x 4 + 4), pulled "
              f"{pulled} (a fence drains the prefetched pull, and the next "
              f"batch pulls again); mean touched rows {mt:.1f} "
              f"of {W}; the meter's push/pull model at them "
              f"{res_a['per_minibatch_bytes_touched']} B a mini-batch "
              f"({res_a['bytes_by_phase_touched']}); "
              f"touched_power_sync_bytes(P={P}, Pk={Pk}, {round(mt)}) = "
              f"{model} B an iteration, x {res_a['iters'][-1] - 1} "
              f"selective iterations of the last batch = "
              f"{model * (res_a['iters'][-1] - 1)} B; by link {by}")
        if pushed != touched * (K * 4 + 4) or pulled < pushed:
            fail("the pushed bytes are not the touched rows' bytes")

        # ---- (b) chaos
        t0 = time.time()
        res_b = timed_driver(args_at(root / "b", extra=(
            "--chaos-seed", "7", "--chaos-drop", "0.25", "--chaos-dup",
            "0.25", "--chaos-crash", "1@2", "--chaos-restart-after", "1")),
            [], {})
        same = {"mean_r": res_b["mean_r"] == res_a["mean_r"],
                "iters": res_b["iters"] == res_a["iters"],
                "phi_acc": bool(torch.equal(res_b["phi_acc"], phi_a))}
        ev = res_b["chaos_events"]
        print(f"[ps] (b) chaos (seed 7, drop 0.25, dup 0.25, shard 1 down at "
              f"push op 2, back 1 op later): events {ev}; retries "
              f"{res_b['ps_retries']}, replayed {res_b['ps_replayed_pushes']}"
              f", recoveries {res_b['ps_recoveries']}, duplicates dropped "
              f"{res_b['ps_duplicates_dropped']}, retry bytes "
              f"{res_b['ps_retry_wire_bytes']}; recovery log "
              f"{[e['event'] for e in res_b['ps_recovery_log']]}; equal to "
              f"(a) bit for bit: {same}  ({time.time() - t0:.1f}s)")
        if not (all(same.values()) and res_b["ps_recoveries"] >= 1
                and ev.get("crash") == 1 and ev.get("restart") == 1
                and ev.get("duplicate", 0) + ev.get("drop", 0) > 0):
            fail("the chaos run differs from the clean PS run or did not "
                 "crash, restart and recover")

        # ---- (c) elastic workers
        t0 = time.time()
        res_c = timed_driver(args_at(root / "c", extra=(
            "--elastic-workers", "w0,w1", "--elastic-events",
            "join:w2@1,leave:w0@2,crash:w2@3")), [], {})
        same = {"mean_r": res_c["mean_r"] == res_a["mean_r"],
                "iters": res_c["iters"] == res_a["iters"],
                "phi_acc": bool(torch.equal(res_c["phi_acc"], phi_a))}
        crash = [e for e in res_c["elastic_log"] if e["event"] == "crash"]
        print(f"[ps] (c) elastic: events {res_c['elastic_log']}; workers at "
              f"the end {res_c['ps_workers']}; equal to (a) bit for bit: "
              f"{same}  ({time.time() - t0:.1f}s)")
        if not (all(same.values()) and crash and crash[0]["replayed"]):
            fail("the elastic run differs from the clean PS run or replayed "
                 "no batch")

        # ---- (d) crash-resume
        t0 = time.time()
        d_args = args_at(root / "d", extra=("--crash-at", "3"))
        try:
            timed_driver(d_args, [], {})
        except SystemExit as e:
            print(f"[ps] (d) {e}")
        else:
            fail("--crash-at 3 did not end the PS run")
        res_d = timed_driver(d_args, [], {})
        same = {"first_m": res_d["first_m"] == 2,
                "mean_r": res_d["mean_r"] == res_a["mean_r"][2:],
                "iters": res_d["iters"] == res_a["iters"][2:],
                "phi_acc": bool(torch.equal(res_d["phi_acc"], phi_a))}
        print(f"[ps] (d) resumed at m={res_d['first_m']}: mean_r "
              f"{res_d['mean_r']}; equal to (a) bit for bit: {same}  "
              f"({time.time() - t0:.1f}s)")
        if not all(same.values()):
            fail(f"the resumed PS run differs from (a): first differing "
                 f"batch {first_difference(res_d, res_a, 2)}")

        # ---- (e) bounded staleness with link latency
        t0 = time.time()
        res_e = timed_driver(args_at(root / "e", extra=(
            "--staleness", "1", "--ps-latency", "0.001")), [], {})
        phi_e = res_e["phi_acc"]
        held_e = abs(float(phi_e.double().sum()) - res_e["tokens"]) / \
            res_e["tokens"]
        print(f"[ps] (e) --staleness 1 --ps-latency 0.001: mean_r "
              f"{res_e['mean_r']}  iters {res_e['iters']}; tokens held to "
              f"rel {held_e:.1e}; pull wait {res_e['ps_pull_wait_s']:.3f} s, "
              f"push wait {res_e['ps_push_wait_s']:.3f} s (against (a)'s "
              f"{res_a['ps_pull_wait_s']:.3f} s, {res_a['ps_push_wait_s']:.3f}"
              f" s)  ({time.time() - t0:.1f}s)  [{card}]")
        if not (bool(torch.isfinite(phi_e).all()) and held_e <= 1e-4
                and all(r == r for r in res_e["mean_r"])):
            fail("the staleness-1 run is not finite or does not hold every "
                 "token")

        # ---- (f) where (a)'s time went
        def rate(ms, nbytes):
            # device ms (CUDA events; none off a card) and GB/s
            return ("not measured" if ms is None else
                    f"{ms:.3f} ms = {nbytes / ms / 1e6:.2f} GB/s")

        rows_ms = []
        for i, c in enumerate(res_a["ps_copies"]):
            nbytes = c["rows"] * (K * 4 + 8)       # f32 values, int64 ids
            bound = nbytes / PCIE_BYTES_PER_S * 1e3
            rows_ms.append((c["h2d_ms"], c["d2h_ms"], bound))
            print(f"[ps] (f) batch {i + 1}: {c['rows']} touched rows "
                  f"({nbytes / 1e6:.1f} MB); host->card write "
                  f"{rate(c['h2d_ms'], nbytes)} (host staging and enqueue "
                  f"{c['h2d_host_ms']:.3f} ms); card->host read "
                  f"{rate(c['d2h_ms'], nbytes)} (host wall "
                  f"{c['d2h_host_ms']:.3f} ms); PCIe bound {bound:.3f} ms "
                  f"each  [{card}]")
        h2d, d2h, bnd = (median([r[j] or 0.0 for r in rows_ms])
                         for j in range(3))
        add_at = [v * 1e3 for v in pushes.values()]
        print(f"[ps] (f) medians of {len(rows_ms)}: host->card {h2d:.3f} ms, "
              f"card->host {d2h:.3f} ms, PCIe bound {bnd:.3f} ms; the "
              f"server's np.add.at a push (4 shards) "
              + ", ".join(f"{x:.1f}" for x in add_at)
              + f" ms, median {median(add_at):.1f} ms; step walls (warmed) "
              f"{', '.join(f'{w * 1e3:.3f}' for w in walls[-n:])} ms against "
              f"--backend sim's {', '.join(f'{w * 1e3:.3f}' for w in sim_walls)}"
              f" ms; pull wait {res_a['ps_pull_wait_s']:.3f} s, push wait "
              f"{res_a['ps_push_wait_s']:.3f} s, stream wall "
              f"{res_a['wall_s']:.2f} s (sim {sim['wall_s']:.2f} s)  [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return net


# --------------------------------------------------------------- phase 12

# operations a (token, topic) pair of a sweep: the score (3 smoothing
# adds, 3 logs, an add and a subtraction, the noise add, the compare) and,
# drawn by the pre-pass, Philox4x32-10 (10 rounds of 2 multiplies-low, 2
# multiplies-high, 4 XORs, 2 key adds) and its Gumbel map (shift, convert,
# add, multiply, 2 logs, 2 negations)
GIBBS_SCORE_OPS, GIBBS_DRAW_OPS = 10, 108


def gibbs_case(seed, *, T, D, K, W, device="cuda", kind="docs"):
    """One sweep's inputs: T tokens over D documents, a random z and its
    counts, and [T, K] Gumbel noise, made from ``seed`` with numpy.
    ``kind``: "docs", tokens in document order (the last document one
    token, word W - 1 appearing once); "shuffled", the same in a random
    order; "repeats", words in runs of 3 consecutive tokens, runs crossing
    document boundaries; "singletons", one token a document (D = T);
    "ties", one document, one word, z = [0, 0, 1, 1, ...], noise 0, so
    every draw is a tie the lowest topic wins.  Returns (cfg, doc_ids,
    word_ids, (z, n_dk, n_wk, n_k), noise)."""
    import numpy as np
    import torch

    from repro_torch.core import gibbs
    from repro_torch.core.types import LDAConfig

    rng = np.random.default_rng(seed)
    if kind == "ties":
        doc = np.zeros(T, np.int32)
        word = np.zeros(T, np.int32)
        z = (np.arange(T) // 2 % K).astype(np.int32)
        noise = np.zeros((T, K), np.float32)
    else:
        if kind == "singletons":
            D = T
            doc = np.arange(T, dtype=np.int32)
        else:
            doc = np.sort(rng.integers(0, max(D - 1, 1), T)).astype(np.int32)
            doc[-1] = D - 1
        word = rng.integers(0, max(W - 1, 1), T).astype(np.int32)
        word[rng.integers(T)] = W - 1
        if kind == "repeats":
            word = np.repeat(word[::3], 3)[:T]
        if kind == "shuffled":
            perm = rng.permutation(T)
            doc, word = doc[perm], word[perm]
        z = rng.integers(0, K, T).astype(np.int32)
        noise = rng.gumbel(size=(T, K)).astype(np.float32)
    cfg = LDAConfig(vocab_size=W, num_topics=K)
    d = torch.from_numpy(doc).to(device)
    w = torch.from_numpy(word).to(device)
    state = gibbs.gibbs_init(None, d, w, D, cfg,
                             z=torch.from_numpy(z).to(device))
    return cfg, d, w, state, torch.from_numpy(noise).to(device)


def top2_gap(gops, cfg, d, w, state, noise, t: int) -> float:
    """The gap between the two best scores of token ``t`` of a sweep from
    ``state`` on ``noise``: the plain version replays tokens [0, t), then
    token t's assignment is removed and its scores formed."""
    import torch

    z, n_dk, n_wk, n_k = (x.clone() for x in state)
    gops.gibbs_sweep_plain(z[:t], n_dk, n_wk, n_k, d[:t], w[:t], noise[:t],
                           alpha=cfg.alpha, beta=cfg.beta, W=cfg.vocab_size)
    a, b, wb = gops.chain_scalars(cfg.alpha, cfg.beta, cfg.vocab_size)
    k, di, wi = int(z[t]), int(d[t]), int(w[t])
    for row in (n_dk[di], n_wk[wi], n_k):
        row[k] -= 1.0
    scores = noise[t] + ((torch.log(n_dk[di] + a) + torch.log(n_wk[wi] + b))
                         - torch.log(n_k + wb))
    top = torch.topk(scores, min(2, scores.numel())).values
    return float(top[0] - top[-1])


def gibbs_bound(d, w, K):
    """The least time of one chain sweep on these tokens and its noise, and
    what bounds it: the bytes it must move (each touched row of n_dk and
    n_wk read and written once, n_k and z read and written, the ids and
    the [T, K] noise read) over the card's memory rate, and its operations
    (`GIBBS_SCORE_OPS` a token and topic) over the card's f32 rate.  Also a
    simpler count, two rows of K floats a token over the memory rate."""
    import torch

    T = d.shape[0]
    rows = int(torch.unique(d).numel()) + int(torch.unique(w).numel())
    nbytes = 4 * (2 * rows * K + 2 * K + 4 * T + T * K)
    bound, by = bound_ms(nbytes, T * K * GIBBS_SCORE_OPS)
    return bound, by, T * 2 * K * 4 / HBM_BYTES_PER_S * 1e3


def check_gibbs_sweep(gops, *, T, D, K, W, seed, kind="docs", timed=False,
                      noise_view=False):
    """The Gibbs chain kernel against its plain version on the card, with
    injected noise and with its own Philox noise (the plain version makes
    the same noise with `philox_gumbel`): z and the three counts equal
    exactly, the counts consistent (n_k the column sums of n_wk, every
    count a non-negative integer, T tokens held); if z differs, the first
    token that differs and its top-2 score gap are printed.  ``noise_view``
    injects the noise at a 4-byte offset (the chain's 4-byte path).
    Timed: the kernel in both modes (medians of 20 in turns), the plain
    version (3 runs), the latency floor (T steps of the kernel's
    one-barrier block argmax), the block sizes 256, 512 and 1024 in turns
    (5 each), and the bounds of `gibbs_bound`; returns the kernel's
    record."""
    from unittest import mock

    import torch

    cfg, d, w, state, noise = gibbs_case(seed, T=T, D=D, K=K, W=W,
                                         kind=kind)
    T, D = d.shape[0], state[1].shape[0]
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, W=W)
    philox_seed = (seed * 0x9E3779B97F4A7C15) % 2 ** 64
    injected = noise
    if noise_view:
        injected = torch.empty(T * K + 1, device="cuda")[1:].view(T, K)
        injected.copy_(noise)
    err = 0.0
    for label, draw in (("injected", injected), ("philox", philox_seed)):
        got = [x.clone() for x in state]
        want = [x.clone() for x in state]
        gops.gibbs_sweep(*got, d, w, draw, **kw, sweep=1)
        gops.gibbs_sweep_plain(*want, d, w, noise if draw is injected
                               else draw, **kw, sweep=1)
        torch.cuda.synchronize()
        z, n_dk, n_wk, n_k = got
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        held = (torch.equal(n_k, n_wk.sum(0))
                and all(bool((c >= 0).all()) and torch.equal(c, c.round())
                        for c in (n_dk, n_wk, n_k))
                and float(n_wk.sum(dtype=torch.float64)) == T
                and float(n_dk.sum(dtype=torch.float64)) == T)
        print(f"[gibbs] kernel vs plain T={T} D={D} K={K} W={W} ({kind}"
              f"{', noise at a 4-byte offset' if noise_view else ''}), "
              f"{label} noise: z, n_dk, n_wk, n_k equal {same}; counts "
              f"consistent {held}")
        if not same[0]:
            t = int((z != want[0]).nonzero()[0])
            gap = top2_gap(gops, cfg, d, w, state,
                           noise if label == "injected" else
                           gops.philox_gumbel(philox_seed, 1, T, K, "cuda"),
                           t)
            print(f"[gibbs] first token that differs: t={t}, kernel z="
                  f"{int(z[t])}, plain z={int(want[0][t])}; top-2 score "
                  f"gap there {gap:.3e}")
        if not (all(same) and held):
            fail(f"gibbs_sweep disagrees with its plain version at T={T} "
                 f"K={K} W={W} ({kind}, {label} noise)")
        err = max(err, float((n_wk - want[2]).abs().max()))
        del got, want
    if not timed:
        return None
    fresh = lambda draw: lambda: (*[x.clone() for x in state], d, w, draw)  # noqa: E731
    turns = time_turns({
        "philox": (functools.partial(gops.gibbs_sweep, **kw, sweep=1),
                   fresh(philox_seed)),
        "injected": (functools.partial(gops.gibbs_sweep, **kw, sweep=1),
                     fresh(noise))}, 20)
    def at_block(n):
        def run(*args):
            with mock.patch.object(gops, "block_threads", lambda K: n):
                return gops.gibbs_sweep(*args, **kw, sweep=1)
        return run

    blocks = time_turns({f"threads={n}": (at_block(n), fresh(noise))
                         for n in (256, 512, 1024)}, 5)
    plain_ms = time_ms(functools.partial(gops.gibbs_sweep_plain, **kw,
                                         sweep=1), fresh(philox_seed), 3)
    floor_ms = time_ms(lambda: gops.reduce_floor(T, K, "cuda"), tuple, 20)
    bound, bound_by, rows_ms = gibbs_bound(d, w, K)
    ms = turns["injected"]
    binds = "the latency floor" if floor_ms > bound else bound_by
    print(f"[gibbs] gibbs_sweep T={T} K={K} W={W} ({gops.block_threads(K)} "
          f"threads): {ms:.4f} ms ({ms * 1e3 / T:.3f} us a token) on its "
          f"noise, {turns['philox']:.4f} ms with the Philox pre-pass; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}; "
          f"{bound / ms:.2%} of it reached); two rows a token over HBM "
          f"{rows_ms:.4f} ms; latency floor {floor_ms:.4f} ms "
          f"({floor_ms * 1e3 / T:.3f} us a step, {floor_ms / ms:.1%} of the "
          f"chain's time): {binds} binds")
    print("[gibbs] block sizes (injected noise, medians of 5 in turns): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in blocks.items()))
    return kernel_record(
        "gibbs_sweep", "src/repro_torch/csrc/gibbs_sweep.cu",
        "none (added by the port): the lax.scan of "
        "src/repro/core/gibbs.py:73 (gibbs_sweep)", err, ms, plain_ms,
        bound, bound_by, None, ms_philox_with_prepass=turns["philox"],
        bound_token_rows_ms=rows_ms, latency_floor_ms=floor_ms, binds=binds,
        tokens=T, block_threads=gops.block_threads(K),
        ms_by_block_threads=blocks)


def check_gibbs_noise(gops, *, T, K, seed, timed=False):
    """The Philox pre-pass against its plain version (`philox_gumbel` on
    the card): equal exactly, at tokens offset by 5 as a chunk of a sweep
    is.  Timed: medians of 20 of both, the bound (T * K * 4 bytes written,
    `GIBBS_DRAW_OPS` a value over the f32 rate) and the pre-pass's peak
    device memory beyond what was allocated before it; returns its
    record."""
    import torch

    philox_seed = (seed * 0x9E3779B97F4A7C15 + 1) % 2 ** 64
    got = gops.gibbs_noise(philox_seed, 2, T, K, "cuda", t0=5)
    want = gops.philox_gumbel(philox_seed, 2, T, K, "cuda", t0=5)
    err = float((got - want).abs().max())
    same = bool(torch.equal(got, want))
    print(f"[gibbs] gibbs_noise T={T} K={K} (tokens from 5): equal to "
          f"philox_gumbel {same} (max|d| {err:.3e})")
    if not same:
        fail(f"gibbs_noise disagrees with philox_gumbel at T={T} K={K}")
    del got, want
    if not timed:
        return None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gops.gibbs_noise(philox_seed, 0, T, K, "cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    args = lambda: (philox_seed, 0, T, K, "cuda")      # noqa: E731
    ms = time_ms(gops.gibbs_noise, args)
    plain_ms = time_ms(gops.philox_gumbel, args, 3)
    bound, bound_by = bound_ms(4 * T * K, T * K * GIBBS_DRAW_OPS)
    print(f"[gibbs] gibbs_noise T={T} K={K}: {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {bound:.4f} ms ({bound_by}; "
          f"{bound / ms:.2%} of it reached)  peak device memory "
          f"{peak / 2**20:.1f} MiB")
    return kernel_record(
        "gibbs_noise", "src/repro_torch/csrc/gibbs_sweep.cu",
        "none (added by the port): the Gumbel draws of "
        "jax.random.categorical at src/repro/core/gibbs.py:65 over the keys "
        "of jax.random.split at :71", err, ms, plain_ms, bound, bound_by,
        None, tokens=T, peak_mib=peak / 2**20)


def count_gates(label, *, n_dk, n_wk, n_k, T) -> None:
    """The collapsed counts' invariants: n_wk and n_dk each summing to T
    exactly, n_k the column sums of n_wk exactly, every count a
    non-negative integer."""
    import torch

    sums = (float(n_wk.sum(dtype=torch.float64)),
            float(n_dk.sum(dtype=torch.float64)))
    cols = bool(torch.equal(n_k, n_wk.sum(0)))
    whole = all(bool((c >= 0).all()) and bool(torch.equal(c, c.round()))
                for c in (n_dk, n_wk, n_k))
    print(f"[{label}] n_wk sums to {sums[0]:.0f}, n_dk to {sums[1]:.0f} "
          f"(T = {T}); n_k = n_wk's column sums: {cols}; counts "
          f"non-negative integers: {whole}")
    if not (sums == (T, T) and cols and whole):
        fail(f"{label}: the Gibbs counts are inconsistent")


def gibbs_slice(mb, heldout, *, W, K, seed, card, pobp_ppl, sweeps=3):
    """Phase 12 (a): ``run_gibbs`` on one mini-batch at (W, K), the chain
    on the Philox pre-pass's noise from ``seed``, twice.  Gates: the
    counts' invariants, one chain and one pre-pass launch a sweep, the
    second run equal to the first bit for bit (z and the three counts).
    Prints ms a sweep and us a token (CUDA events between sweeps 2..3 of
    both runs) and the held-out perplexity beside ``pobp_ppl``.  Returns
    (the launch counts, ms a sweep)."""
    import torch

    from repro_torch.core import gibbs
    from repro_torch.core.perplexity import evaluate
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import launch_counts

    cfg = LDAConfig(vocab_size=W, num_topics=K)
    T = int(mb.counts.sum())
    runs, sweep_ms = [], []
    for r in range(2):
        events, final = [], {}

        def after(s, z, n_dk, n_wk, n_k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if s == sweeps - 1:
                final.update(z=z.clone(), n_k=n_k.clone())

        torch.cuda.synchronize()
        if r == 0:
            launch_counts(reset=True)            # the main path starts here
        t0 = time.time()
        n_wk, n_dk = gibbs.run_gibbs(
            torch.Generator(device="cuda").manual_seed(seed), mb, cfg,
            sweeps, callback=after, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        if r == 0:
            launches = launch_counts()           # ... and ends here
        sweep_ms += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        runs.append((final["z"], n_dk, n_wk, final["n_k"]))
        print(f"[gibbs] (a) run {r + 1}: {sweeps} sweeps of {T} tokens in "
              f"{wall:.3f} s (init and seed included)  [{card}]")
    want = {k: 0 for k in launches}
    want["gibbs_sweep"] = want["gibbs_noise"] = sweeps   # a chunk a sweep
    print(f"[gibbs] (a) launches {launches}")
    if launches != want:
        fail(f"run_gibbs launched {launches}, expected {want}")
    z, n_dk, n_wk, n_k = runs[0]
    count_gates("gibbs", n_dk=n_dk, n_wk=n_wk, n_k=n_k, T=T)
    same = [bool(torch.equal(a, b)) for a, b in zip(runs[0], runs[1])]
    print(f"[gibbs] (a) second run from seed {seed}: z, n_dk, n_wk, n_k "
          f"equal {same}")
    if not all(same):
        fail("run_gibbs from one seed does not repeat bit for bit")
    del runs
    ms = median(sweep_ms)
    train, test = heldout
    ppl = evaluate(n_wk, train, test, cfg,
                   generator=torch.Generator(device="cuda").manual_seed(
                       seed + 1), device="cuda")
    print(f"[gibbs] (a) W={W} K={K} D={mb.num_docs} T={T}: "
          f"{ms:.3f} ms a sweep ({ms * 1e3 / T:.3f} us a token; median of "
          f"{len(sweep_ms)}: " + ", ".join(f"{x:.3f}" for x in sweep_ms)
          + f" ms); held-out perplexity {ppl:.3f} (phase 6's POBP after its "
          f"last step: {pobp_ppl:.3f})  [{card}]")
    return launches, ms


def vb_slice(mb, heldout, *, W, K, seed, card, iters=5):
    """Phase 12 (b): ``run_vb`` on one mini-batch at (W, K), ``iters``
    iterations from one injected initial lambda, twice.  Gates: lambda -
    beta holding every token (rel 1e-4), gamma finite, the second run equal
    bit for bit, ``word_rows_sum`` launched once an iteration.  Prints ms an
    iteration and the held-out perplexity.  Returns the launches."""
    import torch

    from repro_torch.core import vb
    from repro_torch.core.perplexity import evaluate
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import launch_counts

    cfg = LDAConfig(vocab_size=W, num_topics=K)
    T = float(mb.counts.sum())
    g = torch.Generator(device="cuda").manual_seed(seed)
    lam0 = cfg.beta + (torch.rand((W, K), generator=g, device="cuda") + 0.5)
    runs, walls = [], []
    for r in range(2):
        torch.cuda.synchronize()
        if r == 0:
            launch_counts(reset=True)            # the main path starts here
        t0 = time.time()
        runs.append(vb.run_vb(None, mb, cfg, iters, lam0=lam0,
                              device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if r == 0:
            launches = launch_counts()           # ... and ends here
    del lam0
    want = {k: 0 for k in launches}
    want["word_rows_sum"] = iters
    (phi, gamma), (phi2, gamma2) = runs
    mass = float(phi.sum(dtype=torch.float64))
    same = bool(torch.equal(phi, phi2)) and bool(torch.equal(gamma, gamma2))
    finite = bool(torch.isfinite(gamma).all())
    del runs, phi2, gamma2
    train, test = heldout
    ppl = evaluate(phi, train, test, cfg,
                   generator=torch.Generator(device="cuda").manual_seed(
                       seed + 1), device="cuda")
    print(f"[vb] (b) W={W} K={K} D={mb.num_docs}: {iters} iterations in "
          f"{walls[0] * 1e3:.3f} / {walls[1] * 1e3:.3f} ms = "
          f"{walls[0] * 1e3 / iters:.3f} / {walls[1] * 1e3 / iters:.3f} ms an "
          f"iteration; lambda - beta mass {mass:.3f} against {T:.0f} tokens "
          f"(rel {abs(mass - T) / T:.2e}, tol 1e-4); gamma finite {finite}; "
          f"second run equal {same}; launches {launches}; held-out "
          f"perplexity {ppl:.3f}  [{card}]")
    if not (abs(mass - T) <= 1e-4 * T and finite and same
            and launches == want):
        fail("run_vb does not hold its tokens, is not finite, does not "
             "repeat, or did not launch word_rows_sum once an iteration")
    return launches


def parallel_slice(mb, *, W, K, seed, card, shards=4, sweeps=2):
    """Phase 12 (d): PGS and PVB over one mini-batch split into ``shards``
    shards.  Gates: ``comm_bytes`` = W * K * 4 * shards a sweep or an
    iteration; PGS's global n_wk holding every token; the shared n_wk
    untouched by each shard's sweep (its copy swept, checked around every
    shard's call); PVB's lambda - beta holding every token, finite."""
    from unittest import mock

    import torch

    from repro_torch.core import gibbs, vb
    from repro_torch.core.types import LDAConfig, MiniBatch

    cfg = LDAConfig(vocab_size=W, num_topics=K)
    Dl = mb.num_docs // shards
    parts = [MiniBatch(mb.word_ids[i * Dl:(i + 1) * Dl],
                       mb.counts[i * Dl:(i + 1) * Dl]) for i in range(shards)]
    T = float(sum(float(p.counts.sum()) for p in parts))
    real, kept = gibbs.gibbs_sweep, []

    def watched(draw, z, n_dk, n_wk, n_k, *rest, **kw):
        before = n_wk.clone()
        out = real(draw, z, n_dk, n_wk, n_k, *rest, **kw)
        kept.append(bool(torch.equal(n_wk, before)) and out[2] is not n_wk)
        return out

    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(gibbs, "gibbs_sweep", watched):
        phi, nbytes = gibbs.run_parallel_gibbs(
            torch.Generator(device="cuda").manual_seed(seed + 2), parts, cfg,
            sweeps, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    mass = float(phi.sum(dtype=torch.float64))
    want = W * K * 4 * shards * sweeps
    print(f"[pgs] (d) {shards} shards x {Dl} documents, {sweeps} sweeps in "
          f"{wall:.3f} s: comm_bytes {nbytes:,} (W*K*4*{shards}*{sweeps} = "
          f"{want:,}); n_wk_glob sums to {mass:.0f} (T = {T:.0f}); shared "
          f"n_wk untouched by each of {len(kept)} shard sweeps: {all(kept)}"
          f"  [{card}]")
    if not (nbytes == want and mass == T and all(kept)
            and len(kept) == shards * sweeps):
        fail("run_parallel_gibbs: bytes, tokens or the shared counts wrong")
    del phi
    torch.cuda.synchronize()
    t0 = time.time()
    phi, nbytes = vb.run_parallel_vb(
        torch.Generator(device="cuda").manual_seed(seed + 3), parts, cfg,
        sweeps, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    mass = float(phi.sum(dtype=torch.float64))
    print(f"[pvb] (d) {shards} shards, {sweeps} iterations in {wall:.3f} s: "
          f"comm_bytes {nbytes:,} (expected {want:,}); lambda - beta mass "
          f"{mass:.3f} (rel {abs(mass - T) / T:.2e} of T, tol 1e-4)  [{card}]")
    if not (nbytes == want and abs(mass - T) <= 1e-4 * T
            and bool(torch.isfinite(phi).all())):
        fail("run_parallel_vb: bytes or tokens wrong")


def accuracy_slice(*, card, device="cuda"):
    """Phase 12 (e): the reference accuracy bench's Table 4 analogue, its
    settings copied by value (``benchmarks/common.py:16-30``,
    ``benchmarks/run.py:215-262``): 240 documents of mean length 80 from
    ``lda_corpus(0, 240, 400, 16)``, split 80/20 by token; POBP by
    ``run_stream`` over 60-document mini-batches in 2 shards with power
    sync (lambda_w 0.1, 8 power topics, 60 inner iterations, tolerance
    0.03, seed 1); GS 50 sweeps; VB 25 iterations; a zero phi as
    "random"; every model scored by held-out perplexity with one fold-in
    seed.  Gate: POBP, GS and VB each below random."""
    import torch

    from repro_torch.core import gibbs, vb
    from repro_torch.core.perplexity import evaluate
    from repro_torch.core.pobp import run_stream
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.batching import (docs_to_padded,
                                           sharded_minibatch_stream,
                                           train_test_split_counts)
    from repro_torch.data.synthetic import lda_corpus

    docs, _, _ = lda_corpus(0, 240, 400, 16, doc_len_mean=80)
    train, test = train_test_split_counts(list(docs), 0)
    tr_b, te_b = docs_to_padded(train), docs_to_padded(test)
    cfg = LDAConfig(vocab_size=400, num_topics=16, lambda_w=0.1,
                    lambda_k_abs=8, inner_iters=60, residual_tol=0.03)

    def score(phi):
        return evaluate(phi, tr_b, te_b, cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(5))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    out = {}
    (phi, _, _), dt = timed(lambda: run_stream(
        sharded_minibatch_stream(train, 60, 2), cfg, num_shards=2,
        sync_mode="power", seed=1, device=device))
    out["POBP"] = (score(phi), dt)
    (phi_g, _), dt = timed(lambda: gibbs.run_gibbs(
        torch.Generator(device=device).manual_seed(2), tr_b, cfg, 50,
        device=device))
    out["GS"] = (score(phi_g), dt)
    (phi_v, _), dt = timed(lambda: vb.run_vb(
        torch.Generator(device=device).manual_seed(3), tr_b, cfg, 25,
        device=device))
    out["VB"] = (score(phi_v), dt)
    rand = score(torch.zeros_like(phi))
    print("[accuracy] (e) held-out perplexity, 240 documents, W=400, K=16: "
          + ", ".join(f"{k} {p:.3f} ({dt:.3f} s)" for k, (p, dt)
                      in out.items()) + f", random {rand:.3f}; gap to GS "
          f"{(out['GS'][0] - out['POBP'][0]) / out['GS'][0] * 100:.1f}%"
          f"  [{card}]")
    if not all(p < rand for p, _ in out.values()):
        fail("a comparator does not score below a random model")


# --------------------------------------------------------------- phase 13

LM_STREAMS = 8
# (arch, prompt tokens, new tokens) served at full width and depth
LM_SERVED = (("smollm-360m", 128, 128), ("deepseek-v2-lite-16b", 32, 32))
LM_IDS = ("granite-3-2b", "mistral-large-123b", "qwen2-72b", "smollm-360m",
          "llama-3.2-vision-11b", "mamba2-780m", "deepseek-v2-lite-16b",
          "olmoe-1b-7b", "zamba2-2.7b", "seamless-m4t-medium")


def lm_serve_slice(arch: str, *, prompt: int, gen: int, seed: int,
                   card: str) -> None:
    """``serve --mode lm`` (its ``serve_lm``) at full width and depth, twice
    from ``seed``: logits finite at every step, greedy tokens inside the
    vocabulary, the second run's tokens and one more decode step's logits
    equal to the first's bit for bit; tokens/s, ms a decode step (median
    and range) and peak device memory of each run, and that extra step of
    the first run under the profiler (busy share, device events)."""
    import torch
    from repro_torch.launch import serve

    args = serve.parse_args([
        "--mode", "lm", "--arch", arch, "--batch", str(LM_STREAMS),
        "--prompt-len", str(prompt), "--gen", str(gen), "--seed", str(seed),
        "--device", "cuda"])
    runs, last = [], []
    for rep in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if rep == 0:
            def trace(fn):
                (logits, _), _ = profile_run(
                    fn, f"one {arch} decode step ({LM_STREAMS} streams, "
                    f"cache {prompt + gen})", card)
                last.append(logits)
        else:
            def trace(fn):
                last.append(fn()[0])
        t0 = time.time()
        res = serve.serve_lm(args, trace_step=trace)
        wall = time.time() - t0
        steps = sorted(s * 1e3 for s in res["step_s"])
        print(f"[lm] {arch} run {rep + 1}: {LM_STREAMS} streams, prompt "
              f"{prompt}, {gen} new tokens: {res['tok_per_s']:.1f} tok/s; "
              f"ms a decode step median {steps[len(steps) // 2]:.3f} "
              f"(range {steps[0]:.3f} - {steps[-1]:.3f}, {len(steps)} "
              f"steps); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{wall:.1f}s with init  [{card}]")
        if not res["finite"]:
            fail(f"{arch}: a decode step's logits were not finite")
        toks = res["tokens"]
        if int(toks.min()) < 0 or int(toks.max()) >= res["vocab_size"]:
            fail(f"{arch}: a greedy token outside the vocabulary "
                 f"[0, {res['vocab_size']})")
        runs.append(toks)
    if not (torch.equal(runs[0], runs[1]) and torch.equal(last[0], last[1])):
        fail(f"{arch}: a second serve_lm run from seed {seed} differs")
    print(f"[lm] {arch}: the second run equal bit for bit (tokens, and the "
          f"logits of one more step over the full cache)")


# a routing decision that the decode path and the full forward take
# differently must be a near-tie: its top-k gate margin below this
ROUTER_TIE = 1e-2


class RouteLog:
    """While open, records the experts each MoE layer chose for each token
    ([B, T, k], sorted) and the top-k gate margins ([B, T], the k-th
    largest gate less the next), through ``moe.top_k``."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.top_k, self.layers = moe, moe.top_k, []

        def spy(x, k):
            v, i = self.top_k(x, k + 1)
            self.layers.append((i[..., :k].sort(-1).values,
                                v[..., k - 1] - v[..., k]))
            return v[..., :k], i[..., :k]
        moe.top_k = spy
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.top_k


def route_flips(full: RouteLog, prefill: RouteLog, decode: RouteLog):
    """Rows in which the full forward routed a token (the prefill's tokens
    and the decoded one) to other experts than the prefill and decode did,
    and the largest margin among the differences no earlier one explains
    (an earlier layer of the same row, at this token or before)."""
    import torch

    flipped, worst, seen = set(), 0.0, []
    for (fc, fm), (pc, pm), (dc, dm) in zip(full.layers, prefill.layers,
                                            decode.layers):
        other = torch.cat([pc, dc], 1)
        margin = torch.minimum(fm, torch.cat([pm, dm], 1))
        here = [tuple(ix) for ix in
                (fc != other).any(-1).nonzero().tolist()]
        for b, t in here:
            if not any(sb == b and st <= t for sb, st in seen):
                worst = max(worst, float(margin[b, t]))
            flipped.add(b)
        seen += here
    return flipped, worst


def lm_decode_vs_forward(arch: str, *, full: bool, seed: int) -> None:
    """Prefill 16 tokens through ``forward(mode="prefill")``, grow the
    caches, decode token 17, and hold its logits against a full forward
    over 17 tokens: the reference's own tolerance (``tests/test_archs.py``:
    rtol 0.1, atol 0.15, top-1 agreement >= 0.5, MoE at capacity factor 8
    so that no queue drops differ).  MoE routing is discrete: a row in
    which the two paths routed a token differently is held only by the
    top-1 agreement, and that difference must have been a near-tie
    (``ROUTER_TIE``).  At full width only the top-1 agreement is held; the
    gap is printed."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map

    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    mod = registry.build(cfg)
    params = mod.init(cfg, seed=seed, device="cuda")
    B, S = 2, 16
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device="cuda", dtype=torch.int32)

    def embeds(n):
        return torch.randn((B, n, cfg.d_model), generator=gen,
                           device="cuda").bfloat16()

    if cfg.family == "audio":           # the encoder's memory spans 17 frames
        frames = embeds(S + 1)
        fwd = lambda t: mod.forward(params, t, frames, cfg,  # noqa: E731
                                    mode="prefill")
    else:
        image = embeds(cfg.frontend_tokens) if cfg.family == "vlm" else None
        fwd = lambda t: mod.forward(params, t, cfg,  # noqa: E731
                                    image_embeds=image, mode="prefill")

    def grown(c, t):
        out = t.clone()
        out[tuple(slice(0, n) for n in c.shape)] = c
        return out

    with RouteLog() as full_log:
        full_logits, _, _ = fwd(tokens)
    with RouteLog() as prefill_log:
        _, caches, _ = fwd(tokens[:, :S])
    caches = tree_map(grown, caches, registry.cache_zeros(cfg, B, S + 1,
                                                         device="cuda"))
    with RouteLog() as decode_log:
        logits, _ = mod.decode_step(params, tokens[:, S:], caches, S, cfg)
    flipped, worst = route_flips(full_log, prefill_log, decode_log)
    a = logits[:, 0, :cfg.vocab_size].float()
    b = full_logits[:, S, :cfg.vocab_size].float()
    rows = [r for r in range(B) if r not in flipped]
    gap = float((a - b).abs().max())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    within = bool(torch.allclose(a[rows], b[rows], rtol=0.1, atol=0.15))
    print(f"[lm] decode vs forward {arch} "
          f"({'full width' if full else 'reduced'}): max |gap| {gap:.4f} "
          f"(logits up to {float(b.abs().max()):.3f}), rows routed alike "
          f"{len(rows)} of {B}, within rtol 0.1 atol 0.15: {within}, top-1 "
          f"agreement {top1:.2f}")
    if flipped:
        print(f"[lm]   rows {sorted(flipped)} routed a token to other experts "
              f"in the two paths; the first such choice's gate margin "
              f"{worst:.2e} (a near-tie below {ROUTER_TIE})")
    if top1 < 0.5 or worst >= ROUTER_TIE or not (full or within):
        fail(f"{arch}: decode after prefill disagrees with the full forward")


def lm_slice(*, seed: int, card: str) -> None:
    """Phase 13: LM serving through ``serve --mode lm`` at full width and
    depth, then decode against forward for every id."""
    import torch

    for arch, prompt, gen in LM_SERVED:
        lm_serve_slice(arch, prompt=prompt, gen=gen, seed=seed, card=card)
        torch.cuda.empty_cache()
    for arch in LM_IDS:
        lm_decode_vs_forward(arch, full=False, seed=seed)
    lm_decode_vs_forward("smollm-360m", full=True, seed=seed)


# --------------------------------------------------------------- phase 14

# (arch, batch, seq, steps) trained at full width and depth, two shards
LM_TRAIN_MAIN = ("smollm-360m", 8, 4096, 12)
LM_TRAIN_SSM = ("mamba2-780m", 8, 2048, 6)
LM_RESUME_TOL = 2e-4      # the reference's crash-resume tolerance


def lm_train_args(ckpt_dir, *, arch, batch, seq, steps, seed, extra=()):
    from repro_torch.launch import train

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--shards", "2", "--sync", "power",
            "--log-every", "4", "--seed", str(seed), "--device", "cuda"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--ckpt-every", "4"]
    return train.build_parser().parse_args(argv + list(extra))


def timed_train(args, io: dict, trace_step=None):
    """``train.train_loop(args)`` with each step's wall (host clock, ended
    by the read of its loss) and the checkpoint saves' and restores'
    seconds in ``io``.  Returns (losses, meter)."""
    from unittest import mock

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import train

    def clocked(fn, key):
        def run(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            io.setdefault(key, []).append(time.time() - t0)
            return out
        return run

    walls = io.setdefault("walls", [])
    with mock.patch.object(ckpt, "save", clocked(ckpt.save, "save_s")), \
            mock.patch.object(ckpt, "restore", clocked(ckpt.restore,
                                                       "restore_s")):
        return train.train_loop(args, step_walls=walls,
                                trace_step=trace_step)


def step_reading(walls, tokens: int, first: int = 2) -> str:
    """Median and range of the step walls from step ``first`` (0-based)
    on, and tokens/s at the median."""
    ms = sorted(w * 1e3 for w in walls[first:])
    mid = ms[len(ms) // 2]
    return (f"ms a step median {mid:.1f} (range {ms[0]:.1f} - {ms[-1]:.1f}, "
            f"{len(ms)} steps), {tokens / mid * 1e3:.0f} tokens/s")


def lm_train_slice(*, seed: int, card: str) -> dict:
    """Phase 14: LM training through ``launch/train.py`` at full width and
    depth: (a) smollm-360m, 2 shards, PowerSync, a checkpoint every 4
    steps; (b) its crash at 8 and the rerun, equal to (a); (c) (a)'s cell
    with the dense sync; (d) mamba2-780m.  Returns the kernels' launches
    of (a), the main path, the device ms a launch of the power-pack
    kernels in (a)'s profiled step, and (a)'s median step in seconds."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts

    root = ROOT / "build" / "chip_smoke_lm_train"
    shutil.rmtree(root, ignore_errors=True)
    arch, B, S, steps = LM_TRAIN_MAIN
    tokens = B * S
    try:
        # (a) the main cell
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)                # the main path starts here
        io_a = {}

        watched = {}

        def profiled(run):
            out, got = profile_run(
                run, f"one {arch} training step (2 shards x {B // 2} x "
                f"{S}, PowerSync)", card,
                watch=("pack_rows_kernel", "scatter_add_rows_kernel"))
            watched.update(got)
            return out

        losses_a, meter_a = timed_train(
            lm_train_args(root / "a", arch=arch, batch=B, seq=S, steps=steps,
                          seed=seed), io_a, trace_step=(1, profiled))
        peak_a = torch.cuda.max_memory_allocated() / 2**30
        print(f"[lm-train] (a) {arch} full width, 2 shards x {B // 2} x {S}, "
              f"PowerSync, {steps} steps: losses {losses_a[0]:.4f} -> "
              f"{losses_a[-1]:.4f}; {step_reading(io_a['walls'], tokens)} "
              f"(steps 3-{steps}; step 2 profiled); peak device memory "
              f"{peak_a:.2f} GiB; checkpoint saves "
              + ", ".join(f"{s:.2f}" for s in io_a.get("save_s", []))
              + f" s  [{card}]")
        launches = launch_counts()               # ... and ends here
        print(f"[lm-train] (a) bytes a step by phase: "
              f"{meter_a.bytes_by_phase}")
        if not all(np.isfinite(losses_a)) or not losses_a[-1] < losses_a[0]:
            fail(f"(a) {arch}: losses not finite or not falling: {losses_a}")
        gate_pack_launches("(a)", launches, arch=arch, steps=steps)

        # (b) crash at 8, then the same command again
        io_b = {}
        launch_counts(reset=True)
        args_b = lm_train_args(root / "b", arch=arch, batch=B, seq=S,
                               steps=steps, seed=seed,
                               extra=("--crash-at", "8"))
        try:
            crashed, _ = timed_train(args_b, io_b)
        except SystemExit as e:
            print(f"[lm-train] (b) {e}")
        else:
            fail("(b) --crash-at 8 did not end the run")
        args_b.crash_at = 0
        resumed, _ = timed_train(args_b, io_b)
        tail_a = losses_a[8:]
        tail_b = resumed[-len(tail_a):]
        exact = tail_a == tail_b
        close = np.allclose(tail_b, tail_a, rtol=LM_RESUME_TOL,
                            atol=LM_RESUME_TOL)
        print(f"[lm-train] (b) crash at 8, resumed from step 4: steps 9-12 "
              f"losses {tail_b} against (a)'s {tail_a}: "
              + ("equal bit for bit" if exact else
                 f"max gap {np.abs(np.subtract(tail_b, tail_a)).max():.3e} "
                 f"(not bit for bit)")
              + f"; restore {io_b.get('restore_s', [0])[0]:.2f} s")
        if not (exact or close):
            fail(f"(b) resumed losses {tail_b} differ from (a)'s {tail_a} "
                 f"past rtol = atol = {LM_RESUME_TOL}")
        # the crashed run's 8 steps, then the resumed run's from the
        # checkpoint at step 4 (the crash comes before step 8's save)
        gate_pack_launches("(b)", launch_counts(), arch=arch,
                           steps=8 + steps - 4)
        shutil.rmtree(root, ignore_errors=True)

        # (c) (a)'s cell with the dense all-reduce
        io_c = {}
        launch_counts(reset=True)
        losses_c, meter_c = timed_train(
            lm_train_args(None, arch=arch, batch=B, seq=S, steps=steps,
                          seed=seed, extra=("--sync", "dense")), io_c)
        payload = meter_a.phase_bytes("powersync_payload")
        dense = meter_c.phase_bytes("dense_grads")
        print(f"[lm-train] (c) dense sync: {step_reading(io_c['walls'], tokens)}"
              f"; PowerSync's {step_reading(io_a['walls'], tokens)}")
        print(f"[lm-train] (c) payload {payload} bytes a step = "
              f"{payload / dense:.4f} x dense_grads {dense} (norms "
              f"{meter_a.phase_bytes('powersync_norms')}, small leaves "
              f"{meter_a.phase_bytes('powersync_dense')})")
        print("[lm-train] (c) step  power   dense")
        for i, (lp, ld) in enumerate(zip(losses_a, losses_c)):
            print(f"[lm-train] (c) {i + 1:4d}  {lp:.4f}  {ld:.4f}")
        if not payload < 0.25 * dense:
            fail(f"(c) PowerSync payload {payload} is not under 0.25 x the "
                 f"dense bytes {dense}")
        if not all(np.isfinite(losses_c)):
            fail(f"(c) dense-sync losses not finite: {losses_c}")
        gate_pack_launches("(c)", launch_counts(), arch=arch, steps=0)

        # (d) the SSD scan's backward at full width
        arch_d, B_d, S_d, steps_d = LM_TRAIN_SSM
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        io_d = {}
        launch_counts(reset=True)
        losses_d, _ = timed_train(
            lm_train_args(None, arch=arch_d, batch=B_d, seq=S_d,
                          steps=steps_d, seed=seed), io_d)
        print(f"[lm-train] (d) {arch_d} full width, 2 shards x {B_d // 2} x "
              f"{S_d}, PowerSync, remat 'full', {steps_d} steps: losses "
              f"{losses_d[0]:.4f} -> {losses_d[-1]:.4f}; "
              f"{step_reading(io_d['walls'], B_d * S_d)}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        if not all(np.isfinite(losses_d)) or not losses_d[-1] < losses_d[0]:
            fail(f"(d) {arch_d}: losses not finite or not falling: "
                 f"{losses_d}")
        gate_pack_launches("(d)", launch_counts(), arch=arch_d,
                           steps=steps_d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()

    # (e) the ten ids at reduced(): loss_fn and its grads on the card
    # against the CPU; PowerSync's kernels against their plain versions on
    # a stacked grad tree of odd leaves, then at (a)'s leaf shapes
    for arch_e in LM_IDS:
        lm_grads_card_vs_cpu(arch_e, seed=seed)
    powersync_card_vs_plain(*odd_grad_tree(seed=seed), label="odd leaves")
    powersync_card_vs_plain(*full_grad_tree(arch, seed=seed),
                            label=f"{arch}'s leaves")
    return launches, watched, step_median_s(io_a["walls"])


def powersync_kernel_leaves(arch: str) -> int:
    """The leaves of ``arch``'s full-width params that PowerSync packs
    (>= 2-D and past ``min_dense_size``): each takes one ``pack_rows`` and
    two ``scatter_add_rows`` a shard a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.powersync import PowerSyncConfig

    cfg = get_config(arch)
    small = PowerSyncConfig().min_dense_size
    return sum(1 for _, p in tree_leaves(registry.build(cfg).init(
        cfg, seed=0, device="meta")) if p.dim() >= 2 and p.numel() > small)


def gate_pack_launches(run: str, launches: dict, *, arch: str,
                       steps: int) -> None:
    """Fail unless ``run``'s launches of the power-pack kernels are exactly
    PowerSync's: steps x 2 shards x packed leaves for ``pack_rows``, twice
    that for ``scatter_add_rows``."""
    want = steps * 2 * powersync_kernel_leaves(arch)
    got = (launches["pack_rows"], launches["scatter_add_rows"])
    print(f"[lm-train] {run} kernel launches: pack_rows {got[0]}, "
          f"scatter_add_rows {got[1]} (steps x shards x packed leaves = "
          f"{want}, twice that for the scatter)")
    if got != (want, 2 * want):
        fail(f"{run}: PowerSync launched the power-pack kernels {got} "
             f"times, expected {(want, 2 * want)}")


def lm_batch(cfg, B: int, S: int, seed: int, device):
    """The batch of the reference's ``tests/test_archs.py::make_batch``:
    random tokens, labels the tokens rolled by one, bf16 patch embeddings
    (vlm) or frames (audio)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model), generator=gen).bfloat16()
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, S, cfg.d_model),
                                      generator=gen).bfloat16()
    return {k: v.to(device) for k, v in batch.items()}


def lm_loss_and_grads(mod, params, batch, cfg):
    import torch

    from repro_torch.models.common import tree_leaves, tree_unflatten

    leaves = [x.detach().requires_grad_() for _, x in tree_leaves(params)]
    loss = mod.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def lm_grads_card_vs_cpu(arch: str, *, seed: int) -> None:
    """``loss_fn`` and its grads in float32 on the card against the CPU from
    the same params and batch: the loss within rtol 1e-4, each grad leaf
    within a relative L2 error of 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    mod = registry.build(cfg)
    host = tree_map(lambda t: t.float(), mod.init(cfg, seed=seed,
                                                  device="cpu"))
    batch = lm_batch(cfg, 2, 32, seed + 5, "cpu")
    want_loss, want = lm_loss_and_grads(mod, host, batch, cfg)
    got_loss, got = lm_loss_and_grads(
        mod, tree_map(lambda t: t.cuda(), host),
        {k: v.cuda() for k, v in batch.items()}, cfg)
    worst = 0.0
    for (path, _), g, w in zip(tree_leaves(host), got, want):
        norm = float(w.norm())
        err = float((g.cpu() - w).norm())
        worst = max(worst, err / norm if norm else err)
        if not err <= 1e-3 * norm:
            fail(f"(e) {arch}: grad {path} on the card off the CPU's by a "
                 f"relative L2 error {err / max(norm, 1e-30):.3e}")
    gap = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    print(f"[lm-train] (e) {arch} reduced, f32: loss card {float(got_loss):.6f}"
          f" cpu {float(want_loss):.6f} (rel {gap:.2e}); worst grad rel L2 "
          f"{worst:.2e} over {len(want)} leaves")
    if not gap <= 1e-4:
        fail(f"(e) {arch}: loss on the card off the CPU's by {gap:.3e}")


def odd_grad_tree(*, seed: int):
    """A stacked grad tree over 2 shards of odd leaves (a leaf with zero
    rows, a stacked 3-D leaf, a bf16 leaf, a list, a 1-D and a small
    leaf) on the card, and a residual for it."""
    import torch

    from repro_torch.models.common import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    emb = rnd(2, 4096, 96)
    emb[:, ::3] = 0.0
    grads = {"embed": emb, "stack": {"w": rnd(2, 4, 96, 160),
                                     "wb": rnd(2, 300, 200).bfloat16()},
             "norm": rnd(2, 96), "small": rnd(2, 16, 16),
             "head_blocks": [{"w": rnd(2, 130, 70)}]}
    return grads, tree_map(lambda g: 0.1 * rnd(*g.shape), grads)


def full_grad_tree(arch: str, *, seed: int):
    """A stacked float32 grad tree over 2 shards with ``arch``'s full-width
    leaf shapes on the card (the embedding's rows of tokens a batch does
    not hold are zero), and a residual for it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)

    def rnd(p):
        return torch.randn((2, *p.shape), generator=gen, device="cuda")

    grads = tree_map(rnd, registry.build(cfg).init(cfg, seed=0,
                                                   device="meta"))
    grads["embed"][:, 1::2] = 0.0
    return grads, tree_map(lambda g: 0.1 * torch.randn(
        g.shape, generator=gen, device="cuda"), grads)


def powersync_card_vs_plain(grads, res, *, label: str) -> None:
    """PowerSync over 2 lockstep shards on the card, through the power-pack
    kernels and again through their plain versions, on the stacked grad
    tree ``grads`` with the residual ``res``: synced within 1e-6, the
    residual exact, the sent masks equal."""
    from unittest import mock

    import torch

    from repro_torch.core.sync import SimReducer, lockstep
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.powersync import PowerSyncConfig, powersync_tree

    def run():
        red = SimReducer(2)
        return lockstep(lambda s: powersync_tree(
            tree_map(lambda a: a[s], grads), tree_map(lambda a: a[s], res),
            red, PowerSyncConfig(), 2), 2, [red], device="cuda")

    n0 = launch_counts()["pack_rows"]
    got = run()
    if launch_counts()["pack_rows"] == n0:
        fail(f"(e) PowerSync on {label} launched no pack_rows")
    with mock.patch.object(pack_ops, "pack_rows", pack_ops.pack_rows_plain), \
            mock.patch.object(pack_ops, "scatter_add_rows",
                              pack_ops.scatter_add_rows_plain):
        want = run()
    worst = 0.0
    for s in range(2):
        for (path, gs), (_, ws), (_, gr), (_, wr) in zip(
                tree_leaves(got[s][0]), tree_leaves(want[s][0]),
                tree_leaves(got[s][1]), tree_leaves(want[s][1])):
            gap = float((gs.float() - ws.float()).abs().max())
            worst = max(worst, gap)
            if gap > 1e-6 or not torch.equal(gr, wr) or not torch.equal(
                    gr == 0, wr == 0):
                fail(f"(e) PowerSync {path} shard {s} on {label}: the "
                     f"kernels differ from the plain versions (synced gap "
                     f"{gap:.3e}, residual equal {torch.equal(gr, wr)})")
    shapes = sorted({tuple(g.shape[1:]) for _, g in tree_leaves(grads)},
                    key=lambda sh: -torch.Size(sh).numel())
    print(f"[lm-train] (e) PowerSync on the card on {label} (largest "
          f"{list(shapes[0])}), kernels against plain versions over 2 "
          f"shards: synced max gap {worst:.3e}, residuals and sent masks "
          f"equal")
    del got, want
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 15

# the dry run's cells, each run as `python -m repro_torch.launch.dryrun`
DRYRUN_CELLS = (("--arch", "smollm-360m", "--shape", "train_4k"),
                ("--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k"),
                ("--lda", "--lda-k", "2000"))
# the reference's in-repo record of the smollm-360m cell, read (never
# written) for its parity values and its XLA terms
DRYRUN_RECORD = (ROOT / "benchmarks" / "results" / "dryrun" /
                 "smollm-360m__train_4k__single.json")
SMOLLM_PARAMS = 361_821_120
SMOLLM_MODEL_FLOPS = 8_892_115_845_120
# the island at full width: deepseek-v2-lite-16b cut to its dense first
# layer and 2 MoE layers, a prefill of 8 x 128 tokens
ISLAND_ARCH, ISLAND_MOE_LAYERS, ISLAND_TOKENS = "deepseek-v2-lite-16b", 2, \
    (8, 128)
ISLAND_TOL = 2e-2          # the reference's bf16 tolerance (test_archs.py)


def start_dryruns(out: Path) -> list:
    """Start the dry run's cells on the host's CPU, each a process of its
    own (the fake process group is process global; this process never
    joins it).  Returns (cell, log, process) triples."""
    import os

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for i, cell in enumerate(DRYRUN_CELLS):
        log = open(out / f"cell{i}.log", "w")
        procs.append((cell, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *cell,
             "--mesh", "single", "--out", str(out)], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    return procs


def finish_dryruns(procs, out: Path, timeout: float = 150.0) -> None:
    """Phase 15 (a): wait for the dry-run cells, then gate their records:
    every cell ``ok``; the smollm-360m cell's params, chips and model
    FLOPs the reference record's; the LDA cells' analytic bytes the
    port's Eq. 5/6 formulas.  The counted terms are printed beside the
    reference record's XLA terms, not gated (the partitioners differ)."""
    from repro_torch.core.sync import dense_sync_bytes, power_sync_bytes

    t_end = time.time() + timeout
    try:
        for cell, log, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                fail(f"(a) the dry run {' '.join(cell)} ran past "
                     f"{timeout:.0f} s")
            log.close()
            if rc:
                tail = Path(log.name).read_text()[-2000:]
                fail(f"(a) the dry run {' '.join(cell)} exited {rc}: {tail}")
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    def record(tag):
        rec = json.loads((out / f"{tag}.json").read_text())
        if rec.get("status") != "ok":
            fail(f"(a) dry-run cell {tag}: {rec.get('status')}")
        return rec

    rec = record("smollm-360m__train_4k__single")
    ref = json.loads(DRYRUN_RECORD.read_text())
    got = (rec["params_total"], rec["params_active"], rec["chips"],
           rec["model_flops"])
    print(f"[dryrun] (a) smollm-360m train_4k single: ok, params "
          f"{got[0]:,} (active {got[1]:,}), chips {got[2]}, model FLOPs "
          f"{got[3]:,.0f} a device; state bytes a device "
          f"{rec['state_bytes_per_device']['total']:,} (the reference's "
          f"argument bytes {ref['memory']['argument_size_in_bytes']:,.0f}); "
          f"probes {rec['probe_s']} s")
    if got != (SMOLLM_PARAMS, SMOLLM_PARAMS, 256, SMOLLM_MODEL_FLOPS):
        fail(f"(a) smollm-360m record {got} is not the reference's "
             f"({SMOLLM_PARAMS}, {SMOLLM_PARAMS}, 256, {SMOLLM_MODEL_FLOPS})")
    print("[dryrun]     counted (port, eager, per device)  |  XLA (the "
          "reference's record)")
    for mine, theirs in (("counted_flops", "hlo_flops"),
                         ("counted_bytes_unfused", "hlo_bytes")):
        print(f"[dryrun]     {mine} {rec[mine]:.4e}  |  {theirs} "
              f"{ref[theirs]:.4e}")
    by_type = {k: f"{v:.3e}" for k, v in
               rec["counted_collective_bytes"].items() if k != "total"}
    print(f"[dryrun]     collective bytes "
          f"{rec['counted_collective_bytes']['total']:.4e} {by_type}  |  "
          f"{ref['collective_bytes']['total']:.4e}")
    for term in ("compute_s", "memory_s", "collective_s", "dominant",
                 "useful_flop_ratio", "roofline_fraction"):
        mine = rec[term]
        theirs = ref[term]
        fmt = (lambda v: v) if isinstance(mine, str) else \
            (lambda v: f"{v:.4e}")
        print(f"[dryrun]     {term} {fmt(mine)}  |  {fmt(theirs)}")
    print(f"[dryrun]     DTensor fallbacks: {rec['replicated_fallbacks']}")

    rec = record("deepseek-v2-lite-16b__decode_32k__single")
    print(f"[dryrun] (a) deepseek-v2-lite-16b decode_32k single (cache_specs, "
          f"cache_pspecs, the island on the fake mesh): ok, params "
          f"{rec['params_total']:,} (active {rec['params_active']:,}), "
          f"state bytes a device {rec['state_bytes_per_device']}, counted "
          f"FLOPs {rec['counted_flops']:.4e}, bytes "
          f"{rec['counted_bytes_unfused']:.4e}, collective bytes "
          f"{rec['counted_collective_bytes']['total']:.4e}, dominant "
          f"{rec['dominant']}; fallbacks {rec['replicated_fallbacks']}")
    for mode in ("power", "dense"):
        rec = record(f"lda-pubmed-K2000__pobp_{mode}__single")
        c = rec["cfg"]
        want = (power_sync_bytes(c["P"], c["Pk"], c["W"]) if mode == "power"
                else 2 * dense_sync_bytes(c["W"], c["K"] // 16))
        loop = lda_loop_ring_bytes(mode, c, data=16, model=16)
        print(f"[dryrun] (a) lda-pubmed-K2000 pobp_{mode}: ok, loop "
              f"{rec['loop_coll_bytes_per_iter']:,.1f} B an iteration "
              f"(its psums' ring bytes {loop:,.1f}; analytic "
              f"{rec['analytic_loop_bytes_per_iter']:,}), once "
              f"{rec['once_coll_bytes']:,.1f} B, a mini-batch at T = 200 "
              f"{rec['minibatch_coll_bytes_T200']:,.1f} B; counted bytes an "
              f"iteration {rec['counted_bytes_unfused_per_iter']:.4e}")
        if rec["analytic_loop_bytes_per_iter"] != want:
            fail(f"(a) lda {mode}: analytic bytes "
                 f"{rec['analytic_loop_bytes_per_iter']} != the formula's "
                 f"{want}")
        if not math.isclose(rec["loop_coll_bytes_per_iter"], loop,
                            rel_tol=1e-12):
            fail(f"(a) lda {mode}: counted loop bytes "
                 f"{rec['loop_coll_bytes_per_iter']} != its psums' ring "
                 f"bytes {loop}")


def lda_loop_ring_bytes(mode: str, c: dict, data: int, model: int) -> float:
    """The link bytes of one further POBP iteration on a data x model mesh,
    from the psums ``core/pobp.py`` issues, each at the all-reduce ring
    factor 2 (G - 1) / G of its group.  Power: the packed d and r over the
    data axis (a rank's Pk is at most its K / model topics) and the [P]
    rw_delta over the model axis; Eq. 6 counts a [W] residual vector
    there, so these bytes fall below it.  Dense: the [W, K / model]
    scatter and r over the data axis, then the [W] residual and the
    [D_m / data, L] normalizer over the model axis."""
    def ring(g):
        return 2 * (g - 1) / g
    kl = c["K"] // model
    if mode == "power":
        return (2 * c["P"] * min(c["Pk"], kl) * 4 * ring(data)
                + c["P"] * 4 * ring(model))
    return (2 * c["W"] * kl * 4 * ring(data)
            + (c["W"] + c["D_m"] // data * c["L"]) * 4 * ring(model))


def step_median_s(walls, first: int = 2) -> float:
    """The median step wall (seconds) from step ``first`` (0-based) on."""
    s = sorted(walls[first:])
    return s[len(s) // 2]


def roofline_share(step_s: float, card: str) -> float:
    """Phase 15 (b): ``roofline.model_flops`` of phase 14 (a)'s step
    (smollm-360m, 2 lockstep shards x 4 x 4096 tokens, chips = 1) over the
    median step times the data-sheet bf16 peak.  Printed, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import registry

    arch, B, S, _ = LM_TRAIN_MAIN
    cfg = get_config(arch)
    active = dryrun.n_active_params(cfg, dryrun.n_params(
        registry.build(cfg).init(cfg, seed=0, device="meta")))
    mf = roofline.model_flops(cfg, ShapeSpec("phase14", S, B, "train"),
                              active, 1)
    share = mf / (step_s * roofline.HW["peak_flops"])
    print(f"[roofline] (b) phase 14 (a)'s {arch} step: model FLOPs "
          f"{mf:.4e} (6 x {active:,.0f} params x {B * S} tokens) in a median "
          f"{step_s * 1e3:.1f} ms = {mf / step_s / 1e12:.2f} TFLOP/s, "
          f"{share:.2%} of the data-sheet bf16 peak "
          f"({roofline.HW['peak_flops'] / 1e12:.1f} TFLOP/s)  [{card}]")
    return share


def island_model(seed: int, device):
    """deepseek-v2-lite-16b at full width (d_model 2048, MLA, 64 experts of
    1408, top-6, 2 shared), its depth cut to the dense first layer and
    ``ISLAND_MOE_LAYERS`` MoE layers; params and tokens from ``seed``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(ISLAND_ARCH)
    cfg = dataclasses.replace(
        cfg, n_layers=cfg.dense_first_n + ISLAND_MOE_LAYERS)
    params = lm.init(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 15)
    tokens = torch.randint(0, cfg.vocab_size, ISLAND_TOKENS, generator=gen,
                           device=device)
    return cfg, params, tokens


class IslandLog:
    """While open, holds each MoE layer the island runs against the local
    path on the same input (the reference test's pair): a list of (max
    |y gap|, within rtol = atol = ISLAND_TOL, aux island, aux local).
    Enter it before a `RouteLog`, whose route records then hold the
    island's choices only."""

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.models.common import NULL_CTX

        self.moe, self.island, self.layers = moe, moe._moe_apply_island, []
        plain_top_k = moe.top_k

        def spy(p, x, *, cfg, ctx):
            import torch

            y, aux = self.island(p, x, cfg=cfg, ctx=ctx)
            routed, moe.top_k = moe.top_k, plain_top_k
            try:
                yl, al = moe._moe_apply_local(p, x, cfg=cfg, ctx=NULL_CTX)
            finally:
                moe.top_k = routed
            a, b = y.float(), yl.float()
            self.layers.append((float((a - b).abs().max()),
                                bool(torch.allclose(a, b, rtol=ISLAND_TOL,
                                                    atol=ISLAND_TOL)),
                                float(aux), float(al)))
            return y, aux
        moe._moe_apply_island = spy
        return self

    def __exit__(self, *exc):
        self.moe._moe_apply_island = self.island


def island_forward(cfg, params, tokens, ctx):
    """A prefill ``forward`` with ``ctx``: (logits, aux, the route log, the
    island's layers against the local path)."""
    from repro_torch.models import lm

    with IslandLog() as island, RouteLog() as log:
        logits, _, aux = lm.forward(params, tokens, cfg, ctx, mode="prefill")
    return logits, aux, log.layers, island.layers


def island_ctx(shape, device_type: str):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ShardingCtx

    return ShardingCtx(active=True, batch=("data",), model="model",
                       mesh=make_mesh(shape, ("data", "model"), device_type))


def island_rank(rank: int, world: int, work: str, seed: int,
                device: str) -> None:
    """One rank of the 1 x ``world`` gloo mesh (a process a rank, all on
    the one card): the island's prefill, saved with the route log and this
    rank's peak memory."""
    import datetime

    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        ctx = island_ctx((1, world), device)
        cfg, params, tokens = island_model(seed, device)
        torch.cuda.reset_peak_memory_stats()
        logits, aux, layers, island = island_forward(cfg, params, tokens,
                                                     ctx)
        torch.cuda.synchronize()
        torch.save({"logits": logits.cpu(), "aux": aux.cpu(),
                    "layers": [(c.cpu(), m.cpu()) for c, m in layers],
                    "island": island,
                    "peak": torch.cuda.max_memory_allocated()},
                   f"{work}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def island_against_local(label, got, want) -> None:
    """The island against the local path.  Each MoE layer on the same
    input (the reference test's pair, ``tests/test_archs.py``): y within
    rtol = atol = ISLAND_TOL in bf16, aux within rtol 1e-4.  The whole
    prefill: the island's partial outputs meet in a sum, so their bf16
    roundings differ from the local path's and a later router may take a
    near-tie the other way; PR 24's rule holds it: the first choice that
    differs in a row must be a near-tie (``ROUTER_TIE``), the tokens
    before it within the reference's full-forward tolerance (rtol 0.1,
    atol 0.15), and the top-1 agreement over all tokens at least 0.9; the
    aux is printed."""
    import torch

    (g, ga, gl, layers), (w, wa, wl, _) = got, want
    for i, (gap, ok, a_isl, a_loc) in enumerate(layers):
        rel = abs(a_isl - a_loc) / abs(a_loc)
        print(f"[island] (c) {label}, MoE layer {i}: y against the local "
              f"path on the same input max |gap| {gap:.4e} (within rtol = "
              f"atol = {ISLAND_TOL}: {ok}), aux rel {rel:.2e}")
        if not ok or rel > 1e-4:
            fail(f"(c) MoE layer {i} on {label} disagrees with the local "
                 f"path")
    if len(layers) != ISLAND_MOE_LAYERS:
        fail(f"(c) {label}: the island ran {len(layers)} layers, not "
             f"{ISLAND_MOE_LAYERS}")
    # a token whose choice differs, and every later token of its row,
    # may differ (attention carries it forward); the first difference in
    # a row must be a near-tie
    B, T = g.shape[:2]
    clean = torch.ones((B, T), dtype=torch.bool)
    worst = 0.0
    for (gc, gm), (wc, wm) in zip(gl, wl):
        diff = (gc.cpu() != wc.cpu()).any(-1)
        margin = torch.minimum(gm.cpu(), wm.cpu())
        for b, t in diff.nonzero().tolist():
            if clean[b, :t + 1].all():
                worst = max(worst, float(margin[b, t]))
            clean[b, t:] = False
    a, b = g.float().cpu(), w.float().cpu()
    gap = float((a - b).abs().max(-1).values[clean].max()) \
        if clean.any() else 0.0
    within = bool(torch.allclose(a[clean], b[clean], rtol=0.1, atol=0.15))
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"[island] (c) {label}, the prefill's logits: max |gap| {gap:.4e} "
          f"over the {int(clean.sum())} of {B * T} tokens before a row's "
          f"first choice that differs (within rtol 0.1, atol 0.15: "
          f"{within}), top-1 agreement {top1:.3f} over all; aux "
          f"{float(ga):.6f} against {float(wa):.6f}"
          + (f"; the first choices that differ in a row on a gate margin "
             f"up to {worst:.2e} (a near-tie below {ROUTER_TIE})"
             if not clean.all() else ""))
    if not within or worst >= ROUTER_TIE or top1 < 0.9:
        fail(f"(c) the island's prefill on {label} disagrees with the local "
             f"path")


def island_slice(*, seed: int, card: str, device: str = "cuda",
                 backend: str = "nccl") -> None:
    """Phase 15 (c): the MoE's expert-parallel island at full width, a
    prefill over 8 x 128 tokens through ``lm.forward`` with an active
    ``ShardingCtx``, on a 1 x 1 mesh in this process (``backend``, NCCL on
    the card) and on a 1 x 2 model axis of two gloo processes on the one
    card (32 experts a rank), each against the local path on the card;
    the two ranks' logits equal bit for bit."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp_mp

    from repro_torch.models.common import NULL_CTX

    cfg, params, tokens = island_model(seed, device)
    torch.cuda.reset_peak_memory_stats()
    want = island_forward(cfg, params, tokens, NULL_CTX)
    torch.cuda.synchronize()
    print(f"[island] (c) {ISLAND_ARCH} at full width (d_model "
          f"{cfg.d_model}, {cfg.moe.num_experts} experts of "
          f"{cfg.moe.d_expert}, top-{cfg.moe.top_k}, {cfg.moe.num_shared} "
          f"shared, MLA), depth cut to {cfg.n_layers} layers (the dense "
          f"first and {ISLAND_MOE_LAYERS} MoE), prefill {ISLAND_TOKENS[0]} x "
          f"{ISLAND_TOKENS[1]} tokens; the local path's peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    work = ROOT / "build" / "chip_smoke_island"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        dist.init_process_group(backend, init_method=f"file://{work}/store11",
                                rank=0, world_size=1)
        try:
            got = island_forward(cfg, params, tokens,
                                 island_ctx((1, 1), device))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        island_against_local(f"a 1 x 1 {backend} mesh in this process", got,
                             want)
        del got, params
        torch.cuda.empty_cache()
        tmp_mp.start_processes(island_rank,
                               args=(2, str(work), seed, device), nprocs=2,
                               join=True, start_method="spawn")
        ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same = torch.equal(ranks[0]["logits"], ranks[1]["logits"]) and \
        torch.equal(ranks[0]["aux"], ranks[1]["aux"])
    print(f"[island] (c) 1 x 2 gloo mesh, two processes on the one card "
          f"({cfg.moe.num_experts // 2} experts a rank): the ranks' logits "
          f"and aux equal bit for bit: {same}; peak memory a rank "
          + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
          + f" GiB  [{card}]")
    if not same:
        fail("(c) the two ranks' logits differ")
    island_against_local("a 1 x 2 gloo mesh", (
        ranks[0]["logits"], ranks[0]["aux"], ranks[0]["layers"],
        ranks[0]["island"]), want)


def powersync_big_leaf(*, seed: int, card: str) -> None:
    """Phase 15 (d): an olmoe-1b-7b expert leaf of 2^31 float32 elements
    ([16, 64, 2048, 1024], [2^21, 1024] in 2-D) synced by ``powersync_tree``
    through the power-pack kernels and again through their plain versions:
    the packed pairs (the synced leaf) and the scattered rows (the
    residual) equal at every pair."""
    from unittest import mock

    import torch

    from repro_torch.core.sync import LocalReducer
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.optim.powersync import PowerSyncConfig, powersync_tree

    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    g = torch.randn((16, 64, 2048, 1024), generator=gen, device="cuda")
    r = 0.1 * torch.randn(g.shape, generator=gen, device="cuda")

    def run():
        torch.cuda.synchronize()
        t0 = time.time()
        s, res = powersync_tree({"w": g}, {"w": r}, LocalReducer(),
                                PowerSyncConfig(), 1)
        torch.cuda.synchronize()
        return (s["w"].reshape(-1, 1024), res["w"].reshape(-1, 1024),
                time.time() - t0)

    n0 = launch_counts()
    got = run()
    n = launch_counts()
    n = (n["pack_rows"] - n0["pack_rows"],
         n["scatter_add_rows"] - n0["scatter_add_rows"])
    with mock.patch.object(pack_ops, "pack_rows", pack_ops.pack_rows_plain), \
            mock.patch.object(pack_ops, "scatter_add_rows",
                              pack_ops.scatter_add_rows_plain):
        want = run()
    # a sent pair whose accumulated value is exactly 0 sends a 0
    equal, sent, zeros = True, 0, 0
    g2, r2 = g.reshape(-1, 1024), r.reshape(-1, 1024)
    for lo in range(0, 2 ** 21, 2 ** 18):
        rows = slice(lo, lo + 2 ** 18)
        for x, y in zip(got[:2], want[:2]):
            equal &= torch.equal(x[rows], y[rows])
        sent += int(torch.count_nonzero(want[0][rows]))
        zeros += int(((g2[rows] + r2[rows]) == 0).sum())
    P, Pc = round(0.2 * 2 ** 21), 512
    print(f"[powersync] (d) a [16, 64, 2048, 1024] leaf (2^31 float32): "
          f"pack_rows x{n[0]}, scatter_add_rows x{n[1]}; synced and "
          f"residual equal to the plain versions at every pair: {equal}; "
          f"{sent:,} non-zero pairs sent (P x Pc = {P * Pc:,}; {zeros} "
          f"accumulated values exactly 0); the sync {got[2] * 1e3:.1f} ms "
          f"through the kernels, {want[2] * 1e3:.1f} ms plain (host clock, "
          f"a sync each end)  [{card}]")
    if n != (1, 2) or not equal or not P * Pc - zeros <= sent <= P * Pc:
        fail("(d) PowerSync on a leaf of 2^31 elements disagrees with the "
             "plain versions")
    del got, want, g, r
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 16

PLACED_REQUESTS = 256       # (b)'s requests, the first of phase 3's


def placed_spec(mesh, W: int, K: int):
    """``phi_serving_spec`` of a [W, K] phi on ``mesh`` (shapes only)."""
    import torch

    from repro_torch.dist.sharding import phi_serving_spec

    return phi_serving_spec(mesh, torch.empty((W, K), device="meta"))


def same_results(got, want) -> bool:
    """Two bursts' results: the same ids, iterations and theta bits."""
    import numpy as np

    g = {r.req_id: r for r in got}
    w = {r.req_id: r for r in want}
    return sorted(g) == sorted(w) and all(
        g[i].iters == w[i].iters and np.array_equal(g[i].theta, w[i].theta)
        for i in w)


def placed_one_by_one(ckpt_dir: Path, docs, *, seed: int, card: str,
                      W: int, K: int) -> int:
    """Phase 16 (a): ``SlabEngine.from_checkpoint(sharding=(mesh,
    phi_serving_spec(mesh, phi)))`` on a 1 x 1 NCCL mesh in this process
    against the unplaced engine, each serving ``docs`` with one seed and
    ``pipeline=0`` (each step harvested at once, so the two admit every
    request at the same step and draw the same init): every theta equal
    bit for bit, the serving kernel launched steps x sweeps times.
    Returns those launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import SlabEngine

    kw = dict(seed=seed, pipeline=0, device="cuda")
    plain = SlabEngine.from_checkpoint(str(ckpt_dir), **kw)
    want, _ = serve_burst(plain, docs)
    del plain
    work = ROOT / "build" / "chip_smoke_placed11"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        dist.init_process_group("nccl", init_method=f"file://{work}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            eng = SlabEngine.from_checkpoint(
                str(ckpt_dir), sharding=(mesh, placed_spec(mesh, W, K)),
                **kw)
            launch_counts(reset=True)            # (a)'s path starts here
            got, wall = serve_burst(eng, docs)
            launches = launch_counts()["power_sweep_carry"]  # ... ends
            steps = eng.stats()["steps"] * eng.sweeps_per_step
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same = same_results(got, want)
    print(f"[placed] (a) 1 x 1 NCCL mesh, phi placed by phi_serving_spec: "
          f"{len(got)} requests, thetas and iterations equal to the "
          f"unplaced engine's bit for bit: {same}; power_sweep_carry "
          f"launches {launches} (steps x sweeps = {steps}); "
          f"{len(got) / wall:.1f} docs/s  [{card}]")
    if not same or launches != steps or launches <= 0:
        fail("(a) the engine placed on a 1 x 1 mesh does not serve as the "
             "unplaced engine through the serving kernel")
    return launches


def placed_rank(rank: int, world: int, work: str, ckpt_dir: str,
                seed: int) -> None:
    """One rank of phase 16 (b)'s 1 x ``world`` gloo mesh (a process a
    rank, all on the one card): both engines placed from the checkpoint,
    each serving ``work/docs.pt``; saves the results, the bytes, the
    theta gather's bytes, the resident phi and this rank's peak memory."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.serve import FoldInEngine, SlabEngine

        inp = torch.load(f"{work}/docs.pt", weights_only=False)
        mesh = make_mesh((1, world), ("data", "model"), "cuda")
        placed = (mesh, placed_spec(mesh, *inp["shape"]))
        torch.cuda.reset_peak_memory_stats()
        out = {}
        for name, cls, kw in (("slab", SlabEngine, {"pipeline": 0}),
                              ("bucket", FoldInEngine, {})):
            eng = cls.from_checkpoint(ckpt_dir, sharding=placed, seed=seed,
                                      device="cuda", **kw)
            results, wall = serve_burst(eng, inp["docs"])
            out[name] = {"results": results, "wall": wall,
                         "bytes": eng.stats()["bytes_by_phase"],
                         "gather": eng.theta_gather_bytes,
                         "phi": (tuple(eng._phi.shape),
                                 eng._phi.numel() * eng._phi.element_size())}
            del eng
        torch.cuda.synchronize()
        out["peak"] = torch.cuda.max_memory_allocated()
        torch.save(out, f"{work}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def placed_two_ranks(ckpt_dir: Path, docs, *, seed: int, card: str,
                     W: int, K: int) -> None:
    """Phase 16 (b): both engines placed on a 1 x 2 gloo mesh of two
    processes on the one card, each rank holding its [W', K/2] block,
    against the one-process ``topic_shards=2`` engines on the same
    requests with the same seed (the slab at ``pipeline=0`` on both
    sides): every theta finite and summing to 1 +- 1e-5, within 1e-5 of
    the one-process engine's, the two ranks equal bit for bit, the bytes
    by phase integer for integer, the resident phi [W', K/2] f32, and
    each rank's peak memory below the one-process engines'."""
    import numpy as np
    import torch
    import torch.multiprocessing as tmp_mp

    from repro_torch.serve import FoldInEngine, SlabEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = {}
    for name, cls, kw in (("slab", SlabEngine, {"pipeline": 0}),
                          ("bucket", FoldInEngine, {})):
        eng = cls.from_checkpoint(str(ckpt_dir), topic_shards=2, seed=seed,
                                  device="cuda", **kw)
        results, wall = serve_burst(eng, docs)
        one[name] = (results, wall, eng.stats()["bytes_by_phase"])
        del eng
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated() - base
    work = ROOT / "build" / "chip_smoke_placed12"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        torch.save({"docs": docs, "shape": (W, K)}, work / "docs.pt")
        tmp_mp.start_processes(placed_rank,
                               args=(2, str(work), str(ckpt_dir), seed),
                               nprocs=2, join=True, start_method="spawn")
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = True
    block = (1, W + 1, K // 2)
    for name in ("slab", "bucket"):
        want, want_wall, want_bytes = one[name]
        w = {r.req_id: r for r in want}
        got = [{r.req_id: r for r in rk[name]["results"]} for rk in ranks]
        th = np.stack([got[0][i].theta for i in sorted(w)])
        gap = float(np.abs(th - np.stack([w[i].theta
                                          for i in sorted(w)])).max())
        sums = float(np.abs(th.sum(axis=1) - 1.0).max())
        iters = sum(got[0][i].iters == w[i].iters for i in w)
        same = same_results(ranks[0][name]["results"],
                            ranks[1][name]["results"])
        by = [rk[name]["bytes"] for rk in ranks]
        phi = [rk[name]["phi"] for rk in ranks]
        print(f"[placed] (b) {name}: {len(w)} requests on 2 gloo ranks: "
              f"max |theta - one process topic_shards=2| {gap:.3e} (tol "
              f"1e-5), sums within {sums:.2e} of 1, iterations equal "
              f"{iters}/{len(w)}; ranks equal bit for bit: {same}; bytes by "
              f"phase equal to the one-process engine's: "
              f"{by[0] == by[1] == want_bytes} ({want_bytes}); resident phi "
              f"a rank {phi[0][0]} f32, {phi[0][1]:,} B; theta gathered "
              f"{ranks[0][name]['gather']:,} B a rank; docs/s "
              + ", ".join(f"{len(w) / rk[name]['wall']:.1f}" for rk in ranks)
              + f" (one process {len(w) / want_wall:.1f})  [{card}]")
        ok &= (np.isfinite(th).all() and sums <= 1e-5 and gap <= 1e-5
               and same and by[0] == by[1] == want_bytes
               and all(p == (block, (W + 1) * (K // 2) * 4) for p in phi))
    peaks = [rk["peak"] for rk in ranks]
    print(f"[placed] (b) peak device memory a rank "
          + ", ".join(f"{p / 2**30:.3f}" for p in peaks)
          + f" GiB against the one-process engines' {one_peak / 2**30:.3f} "
          f"GiB  [{card}]")
    if not ok or max(peaks) >= one_peak:
        fail("(b) topic-sharded serving over two ranks disagrees with the "
             "one-process engine, between the ranks, or holds more than a "
             "rank's block")


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
          f"{1 - busy / wall:.1%}; {sum(dev_n.values())} device events "
          f"(kernels, copies, fills)  [{card}]")
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
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops, packed
    from repro_torch.kernels.power_topics import ops as topics_ops
    from repro_torch.kernels.segment_sum import ops as seg_ops

    # ---- 1. build
    t0 = time.time()
    libs = build.build_all(["power_sweep_carry", "bp_update", "power_pack",
                            "power_sweep_tokens", "segment_sum",
                            "gibbs_sweep", "power_topics"])
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
    # the power-topic selection at both cells' row widths, timed, then at
    # odd widths (4-byte loads, one thread group), Pk of 1 and K
    topics_recs = [check_power_topics(topics_ops, gen, P=14104, K=K, Pk=50,
                                      timed=True) for K in (2000, 10000)]
    for P, K, Pk in ((9, 1, 1), (40, 37, 5), (40, 2001, 50), (9, 300, 300),
                     (40, 20001, 50)):
        check_power_topics(topics_ops, gen, P=P, K=K, Pk=Pk, timed=False)
    # the fixed-order sums at odd shapes: K not a multiple of 4 (scalar
    # loads), a vocabulary of few words, K = 10,000, Pk of 1 and K
    for D, L, K, W in ((3, 7, 37, 5), (4, 16, 100, 3000), (8, 16, 10000, 50)):
        check_word_rows_sum(seg_ops, gen, D=D, L=L, K=K, W=W, timed=False)
    for P, Pk, K in ((9, 1, 100), (9, 37, 37), (300, 50, 10000),
                     (1, 50, 2000), (1001, 7, 300), (50, 2000, 2000)):
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
    # a live-W selection's dead slots: the trailing slots of sel_w all on
    # one all-zero guard row that no token has, each with the same topics;
    # the carry training sweep, the packed sweep and the pack against their
    # plain versions, the sweeps repeating bit for bit, the dead slots'
    # d/r and packs exactly 0 (the scatter's repeated zero rows are above)
    for D, L, K, W, P, Pk, dead in ((4, 7, 100, 50, 9, 5, 3),
                                    (64, 128, 2000, 20000, 1400, 50, 300)):
        check_carry_train(ops, gen, D=D, L=L, K=K, W=W, P=P, Pk=Pk,
                          ragged=True, guard_share=0.3, empty_doc=True,
                          timed=False, dead=dead)
        check_packed_sweep(packed, gen, D=D, L=L, K=K, P=P, Pk=Pk,
                           guard_share=0.3, empty_doc=True, timed=False,
                           dead=dead)
        check_pack_rows(pack_ops, gen, W=W, K=K, P=P, Pk=Pk, outside=False,
                        timed=False, dead=dead)
    # the packed sweep at the slice's shapes with Zipf-like rows and one
    # very long row (the padding slots on word 0's row), timed
    skew = check_packed_sweep(packed, gen, D=512, L=128, K=2000, P=14104,
                              Pk=50, guard_share=0.3, empty_doc=False,
                              timed=True, skewed=True)
    train_recs["power_sweep_tokens"].update(
        {f"{key}_skewed": skew[key] for key in ("ms", "plain_ms", "bound_ms")})
    # the carry training sweep at the k2000 cell's shapes (D = 4096 x
    # L = 128) and skew: a word in every document, runs of C, C + 1, 1 and
    # none, the rest Zipf-like; timed, with its d/r fold's own time
    skew = check_carry_train(ops, gen, D=4096, L=128, K=2000, W=141043,
                             P=14104, Pk=50, ragged=True, guard_share=0.3,
                             timed=True, skewed=True)
    train_recs["power_sweep_carry_train"].update(
        {f"{key}_skewed": skew[key] for key in skew})
    # the Gibbs chain (phase 12's comparators), injected and Philox noise:
    # timed at W = 20,000, T = 4096, K = 2000; then one topic, a warp and
    # one, past 2048 topics, the reference's K = 10,000 and a K past the
    # shared-memory caches (the device-memory path, 16- and 4-byte), every
    # draw a tie, a shuffled token order, words repeated in consecutive
    # tokens and across documents, one-token documents, noise at a 4-byte
    # offset; the Philox pre-pass against its plain version, timed at the
    # main path's token count
    gibbs_rec = check_gibbs_sweep(gibbs_ops, T=4096, D=64, K=2000, W=20000,
                                  seed=args.seed, timed=True)
    past = gibbs_ops.cached_topic_limit("cuda") // 4 * 4 + 4
    for T, D_, K_, W_, kind in ((300, 10, 1, 50, "docs"),
                                (300, 10, 33, 50, "docs"),
                                (200, 6, 2049, 100, "docs"),
                                (128, 4, 10000, 100, "docs"),
                                (64, 3, past, 40, "docs"),
                                (64, 3, past + 1, 40, "docs"),
                                (64, 1, 37, 1, "ties"),
                                (800, 12, 500, 300, "shuffled"),
                                (900, 12, 2000, 60, "repeats"),
                                (400, 0, 64, 500, "singletons")):
        check_gibbs_sweep(gibbs_ops, T=T, D=D_, K=K_, W=W_,
                          seed=args.seed + T + K_, kind=kind)
    check_gibbs_sweep(gibbs_ops, T=600, D=8, K=2000, W=5000, seed=args.seed,
                      noise_view=True)
    noise_rec = check_gibbs_noise(gibbs_ops, T=32768, K=2000, seed=args.seed,
                                  timed=True)
    check_gibbs_noise(gibbs_ops, T=7, K=33, seed=args.seed)
    print(f"[time] phase 2: {time.time() - t0:.1f}s")

    # ---- 3. the serving slice at PUBMED width
    from repro_torch.core import infer

    t0 = time.time()
    # phases 9 and 16 serve from this checkpoint again; phase 16 deletes it
    serve_ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(serve_ckpt, ignore_errors=True)
    engine, docs, results, wall, launches, s = serve_slice(
        W=141043, K=2000, requests=args.requests, seed=args.seed,
        device="cuda", ckpt_dir=serve_ckpt)
    phase3_dps = len(results) / wall
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
               "topic_sum_kernel", "power_topics_kernel"))
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
    _, drv_a, drv_walls = driver_slice(seed=args.seed, docs=args.driver_docs,
                                       card=card)
    drv_a = {k: drv_a[k] for k in ("mean_r", "iters", "phi_acc", "wall_s")}
    print(f"[time] phase 8: {time.time() - t0:.1f}s")

    # ---- 9. multi-shard sync: 4 data shards in lockstep on the card, the
    # driver's mesh (gloo 2x2 on the one card, NCCL 1x1 against one
    # shard), topic-sharded serving.  With topics sharded the dense sweep
    # runs the reference's torch formulation (a normalizer psum'd over the
    # topic shards), not bp_update, and serving runs torch code, not the
    # serving kernel, as the reference runs jnp code there
    t0 = time.time()
    sim_launches, _ = sim_slice(batches, W=W, K=K, seed=args.seed,
                                card=card, single_readings=carry_readings)
    mesh_slice(seed=args.seed, docs=args.driver_docs, card=card)
    sharded_serve(serve_ckpt, docs[:64], seed=args.seed, card=card,
                  phase3_dps=phase3_dps)
    print(f"[time] phase 9: {time.time() - t0:.1f}s")

    # ---- 16. topic-sharded serving over a mesh from phase 3's checkpoint:
    # a 1 x 1 NCCL mesh against the unplaced engine, a 1 x 2 gloo mesh of
    # two processes against the one-process topic_shards=2 engines.  Run
    # here, right after phase 9, so the checkpoint is deleted before the
    # later phases write theirs
    t0 = time.time()
    try:
        placed_launches = placed_one_by_one(serve_ckpt, docs,
                                            seed=args.seed, card=card,
                                            W=141043, K=2000)
        placed_two_ranks(serve_ckpt, docs[:PLACED_REQUESTS], seed=args.seed,
                         card=card, W=141043, K=2000)
    finally:
        shutil.rmtree(serve_ckpt, ignore_errors=True)
    print(f"[time] phase 16: {time.time() - t0:.1f}s")

    # ---- 10. dynamic vocabulary and the stream lifecycle through the
    # driver at PUBMED width: growth, crash-resume across growth, grown
    # against fresh, the sliding stream's fences, serving after a fence
    t0 = time.time()
    with drawn_once() as drawn:
        life_launches = lifecycle_slice(seed=args.seed,
                                        docs=args.driver_docs, card=card)
        # (e) topic recycling: the fence's host round trip in both dtypes
        recycle_slice(seed=args.seed, docs=args.driver_docs, card=card)
    print(f"[time] phase 10: {time.time() - t0:.1f}s ({len(drawn)} batches "
          f"drawn on the host, each once)")

    # ---- 11. the parameter server through the driver at PUBMED width:
    # staleness 0 against --backend sim, chaos, elastic workers,
    # crash-resume, staleness 1, the replica's copies and the server's adds
    t0 = time.time()
    ps_launches = ps_slice(seed=args.seed, docs=args.driver_docs, card=card,
                           sim=drv_a, sim_walls=drv_walls)
    del drv_a
    print(f"[time] phase 11: {time.time() - t0:.1f}s")

    # ---- 12. the paper's comparators at PUBMED width: Gibbs and VB on
    # phase 6's first mini-batch, the chain kernel against its plain
    # version, PGS and PVB over 4 shards, the accuracy comparison
    t0 = time.time()
    gibbs_launches, gibbs_ms = gibbs_slice(
        batches[0], (train, test), W=W, K=K, seed=args.seed, card=card,
        pobp_ppl=ppl)
    vb_launches = vb_slice(batches[0], (train, test), W=W, K=K,
                           seed=args.seed, card=card)
    # the chain at the main path's shape (phase 6's first mini-batch's
    # token count)
    T = int(batches[0].counts.sum())
    check_gibbs_sweep(gibbs_ops, T=T, D=D, K=K, W=W, seed=args.seed + T + K)
    parallel_slice(batches[0], W=W, K=K, seed=args.seed, card=card)
    accuracy_slice(card=card)
    print(f"[time] phase 12: {time.time() - t0:.1f}s")

    # ---- 13. LM serving: smollm-360m and deepseek-v2-lite-16b served at
    # full width and depth, decode against forward for all ten ids
    del batches, train, test
    torch.cuda.empty_cache()
    t0 = time.time()
    lm_slice(seed=args.seed, card=card)
    print(f"[time] phase 13: {time.time() - t0:.1f}s")

    # ---- 14. LM training: smollm-360m at full width with PowerSync (its
    # pack and scatters on the power-pack kernels), crash-resume, the
    # dense sync, mamba2-780m, the ten ids' grads against the CPU
    t0 = time.time()
    lm_launches, lm_watch, lm_step_s = lm_train_slice(seed=args.seed,
                                                      card=card)
    print(f"[time] phase 14: {time.time() - t0:.1f}s")

    # ---- 15. the dry run (three cells, each a CPU process of its own,
    # run while the card works), the roofline share of phase 14's step,
    # the MoE's expert-parallel island at full width, PowerSync on a leaf
    # of 2^31 elements
    t0 = time.time()
    dry_out = ROOT / "build" / "chip_smoke_dryrun"
    dryruns = start_dryruns(dry_out)
    try:
        roofline_share(lm_step_s, card)
        island_slice(seed=args.seed, card=card)
        powersync_big_leaf(seed=args.seed, card=card)
        finish_dryruns(dryruns, dry_out)
    finally:
        for _, log, proc in dryruns:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(dry_out, ignore_errors=True)
    print(f"[time] phase 15: {time.time() - t0:.1f}s")

    # the serving kernel's main path: phase 3's first burst and 16 (a)
    rec["launches"] = launches + placed_launches
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
               "topic_sum": carry_watch.get("topic_sum_kernel"),
               "pack_rows": packed_watch.get("pack_rows_kernel"),
               "power_sweep_tokens": summed(
                   packed_watch, "packed_sweep_kernel",
                   "packed_fold_kernel")}
    for name, r in train_recs.items():
        # the main path's launches: phases 6 or 7, phase 9's simulation,
        # phase 10's grown run and phase 11's PS run (net of their warm-ups),
        # and phase 14 (a)'s LM training (PowerSync's pack and scatters)
        r["launches"] = (packed_launches if name in ("power_sweep_tokens",
                                                     "pack_rows")
                         else train_launches)[name] + sim_launches[name] + \
            life_launches[name] + ps_launches[name] + lm_launches[name]
        r["ms_main_path"] = main_ms[name]
        if name in ("pack_rows", "scatter_add_rows"):
            # device ms a launch in phase 14's profiled step (PowerSync's
            # pack and scatters at the LM's leaf shapes)
            r["ms_lm_train"] = lm_watch.get(f"{name}_kernel")
        kernels.append(r)
    # the selection's main path: phases 6, 9, 10 and 11 (the packed policy
    # of phase 7 selects too, but its launches are not counted here)
    for r in topics_recs:
        r["launches"] = sum(x["power_topics"] for x in (
            train_launches, sim_launches, life_launches, ps_launches))
        r["ms_main_path"] = carry_watch.get("power_topics_kernel")
    kernels += topics_recs
    # VB's statistic (phase 12 (b)) launches the word scatter too
    train_recs["word_rows_sum"]["launches"] += vb_launches["word_rows_sum"]
    # the chain's main path: phase 12 (a), ms a sweep at its shape, the
    # pre-pass's noise included
    gibbs_rec["launches"] = gibbs_launches["gibbs_sweep"]
    gibbs_rec["ms_main_path"] = gibbs_ms
    noise_rec["launches"] = gibbs_launches["gibbs_noise"]
    kernels += [gibbs_rec, noise_rec]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
