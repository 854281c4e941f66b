"""Streaming POBP training driver of the port (counterpart of
``repro.launch.lda_train``): the paper's Fig. 4 outer loop on one device.

The single-shard, fixed-vocabulary path of the reference driver, with its
flag names, its synthetic stream (batch m drawn from (seed, m) off one
fixed ground-truth topic set, L snapped to ``--len-buckets``) and its
held-out split.  Each batch runs ``core.pobp.make_train_step``; the host
reads the diagnostics every ``--log-every`` batches.  ``--eval-every``
scores held-out perplexity through ``core.perplexity.evaluate``;
``--ckpt-dir``/``--ckpt-every`` save checkpoints in the reference's format
(``dist/checkpoint.save``), so ``launch/serve.py`` of either package can
serve them.  ``--device`` (default ``cuda``) picks the card or, when
asked, the CPU.

  PYTHONPATH=src python -m repro_torch.launch.lda_train --minibatches 8 \\
      --docs-per-batch 32 --vocab 300 --topics 16 --lambda-k 8 \\
      --eval-every 4 --ckpt-dir /tmp/lda_ck --ckpt-every 4 --device cuda

Crash-resume, as the reference's: the checkpoint holds the whole state
(phi_acc, m, the generator's state) and the stream cursor, so rerunning
the command with the same ``--ckpt-dir`` resumes from the newest intact
step and reproduces the uninterrupted run bit for bit (the training step
sums in a fixed order on the card too).  The run's trajectory-shaping
flags are saved and checked on resume.  ``--crash-at N`` simulates a
failure after batch N on a fresh run.  ``--warmup-buckets`` (on by
default) pushes each length bucket through the step, and every kernel of
the policy through its first launch, on a throwaway state before the
clock starts.  ``--phi-acc-dtype bfloat16`` stores phi_acc at half width
(stochastic rounding); a resume may switch the dtype, the restore casts.
``--sync-dtype`` is the payload dtype of the compressed syncs.  ``--impl``
names the code the step runs: ``pallas`` the CUDA kernels (a CUDA
``--device``), ``jnp`` their plain versions (``--device cpu``); it follows
the device when not given.

``--sweep-policy`` picks the selective sweep's formulation
(``core/sweep_dispatch``): ``packed`` runs the phi pack and packed-sweep
kernels, every other policy the carry kernel; ``--onehot-crossover`` sets
where the packed sweep's plain version (the CPU path) turns from a one-hot
contraction to a row ``index_add_``; ``--prefetch`` is the depth of the
host thread that draws the stream ahead.

Every other flag of the reference driver is accepted only at its
reference default, and any other value raises naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Any, Dict

import numpy as np

_Q1 = "ROADMAP Queue 1, item"
# flags of the reference driver that are not ported: the value that keeps
# each off, and the ROADMAP item that brings it
_UNPORTED = {
    "shards": (1, f"{_Q1} 5 (multi-shard sync)"),
    "backend": ("sim", f"{_Q1} 5 (shard_map) and item 7 (parameter server)"),
    "mesh": ("single", f"{_Q1} 5 (multi-shard sync)"),
    "mesh_shape": ("", f"{_Q1} 5 (multi-shard sync)"),
    "dynamic_vocab": (False, f"{_Q1} 6 (dynamic vocabulary)"),
    "vocab_growth_per_batch": (24, f"{_Q1} 6 (dynamic vocabulary)"),
    "drift_mode": ("grow", f"{_Q1} 6 (dynamic vocabulary)"),
    "w_cap_min": (64, f"{_Q1} 6 (dynamic vocabulary)"),
    "w_growth": (2.0, f"{_Q1} 6 (dynamic vocabulary)"),
    "compact_every": (0, f"{_Q1} 6 (lifecycle)"),
    "compact_min_idle": (5, f"{_Q1} 6 (lifecycle)"),
    "compact_mass_tol": (25.0, f"{_Q1} 6 (lifecycle)"),
    "recycle_tol": (0.0, f"{_Q1} 6 (lifecycle)"),
    "staleness": (0, f"{_Q1} 7 (parameter server)"),
    "ps_servers": (4, f"{_Q1} 7 (parameter server)"),
    "ps_latency": (0.0, f"{_Q1} 7 (parameter server)"),
    "ps_pull_timeout": (60.0, f"{_Q1} 7 (parameter server)"),
    "chaos_seed": (0, f"{_Q1} 7 (chaos)"),
    "chaos_drop": (0.0, f"{_Q1} 7 (chaos)"),
    "chaos_dup": (0.0, f"{_Q1} 7 (chaos)"),
    "chaos_delay": (0.0, f"{_Q1} 7 (chaos)"),
    "chaos_delay_prob": (0.0, f"{_Q1} 7 (chaos)"),
    "chaos_crash": ("", f"{_Q1} 7 (chaos)"),
    "chaos_restart_after": (2, f"{_Q1} 7 (chaos)"),
    "elastic_workers": ("w0", f"{_Q1} 7 (elastic workers)"),
    "elastic_events": ("", f"{_Q1} 7 (elastic workers)"),
}
# every flag that shapes the per-batch trajectory, saved in the checkpoint
# and checked on resume: the reference's list.  sweep_policy and
# onehot_crossover are not among them (both formulations compute the same
# trajectory within float associativity), nor is phi_acc_dtype (the
# restore casts phi_acc, so a run may switch dtype at a checkpoint fence)
_RESUME_KEYS = ("seed", "sync", "backend", "shards", "vocab", "topics",
                "lambda_w", "lambda_k", "inner_iters", "tol", "sync_dtype",
                "impl", "docs_per_batch", "doc_len_means", "len_buckets",
                "fixed_len", "dynamic_vocab", "vocab_growth_per_batch",
                "w_cap_min", "w_growth", "drift_mode", "decay",
                "compact_every", "compact_min_idle", "compact_mass_tol",
                "recycle_tol", "staleness", "ps_servers")
# the step's code by --impl: "pallas" the CUDA kernels, "jnp" their plain
# versions, each on the one device type that runs it
_IMPL_DEVICE = {"pallas": "cuda", "jnp": "cpu"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minibatches", type=int, default=24)
    ap.add_argument("--docs-per-batch", type=int, default=64)
    ap.add_argument("--doc-len-means", default="12,24,40",
                    help="cycled per mini-batch: a variable-length stream")
    ap.add_argument("--len-buckets", default="16,32,48",
                    help="L buckets (multiples of 8)")
    ap.add_argument("--fixed-len", action="store_true",
                    help="pad every batch to the largest bucket")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="mini-batches the host thread draws ahead "
                         "(0: draw inline)")
    ap.add_argument("--vocab", type=int, default=500)
    ap.add_argument("--topics", type=int, default=16)
    ap.add_argument("--decay", default="1,0",
                    help="Robbins-Monro forgetting 'tau0,kappa' on the phi "
                         "fold; kappa=0 disables")
    ap.add_argument("--lambda-w", type=float, default=0.1)
    ap.add_argument("--lambda-k", type=int, default=8)
    ap.add_argument("--inner-iters", type=int, default=12)
    ap.add_argument("--tol", type=float, default=0.05)
    ap.add_argument("--sync", default="power", choices=["power", "dense"])
    ap.add_argument("--sweep-policy", default="auto",
                    choices=["auto", "packed", "dense_layout", "kblocked"],
                    help="selective-sweep formulation: 'packed' runs the "
                         "phi pack and packed-sweep kernels, every other "
                         "policy the carry kernel (one kernel serves the "
                         "full-K and K-blocked layouts); the same math "
                         "either way")
    ap.add_argument("--onehot-crossover", type=int, default=8_000_000,
                    help="T*P up to which the packed sweep's plain version "
                         "(the CPU path) sums its [P, Pk] buffers by a "
                         "one-hot contraction, a row index_add_ past it; "
                         "the CUDA kernel ignores it")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; pass cpu "
                         "to run the plain versions on the host)")
    ap.add_argument("--impl", default=None, choices=["jnp", "pallas"],
                    help="the step's code: 'pallas' the CUDA kernels (needs "
                         "a CUDA --device), 'jnp' their plain versions "
                         "(needs --device cpu); default: what --device runs")
    ap.add_argument("--phi-acc-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="storage dtype of the phi statistic (bfloat16: "
                         "half the memory, stochastic-rounded fold-back, "
                         "phi syncs shipped at bf16)")
    ap.add_argument("--sync-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="payload dtype of the compressed syncs")
    ap.add_argument("--warmup-buckets", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="before the clock starts, push every length bucket "
                         "and every kernel of the policy through its first "
                         "launch on a throwaway state")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-docs", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a hard failure after minibatch N (fresh "
                         "runs only; needs --ckpt-dir)")
    for name, (default, item) in _UNPORTED.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            ap.add_argument(flag, default=default,
                            action=(argparse.BooleanOptionalAction if default
                                    else "store_true"),
                            help=f"not ported yet ({item})")
        else:
            ap.add_argument(flag, type=type(default), default=default,
                            help=f"not ported yet ({item})")
    return ap


def _csv_ints(s: str):
    return tuple(int(x) for x in str(s).split(",") if str(x).strip())


def _parse_decay(s: str):
    parts = [p.strip() for p in str(s).split(",")]
    if len(parts) != 2:
        raise ValueError(f"--decay expects 'tau0,kappa', got {s!r}")
    return float(parts[0]), float(parts[1])


def _reject_unported(args) -> None:
    for name, (default, item) in _UNPORTED.items():
        value = getattr(args, name)
        if value != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')}={value!r} is not ported yet "
                f"({item}); this driver runs one shard and a fixed "
                f"vocabulary")


def resolve_impl(args) -> str:
    """``--impl``, or what ``--device`` runs when it is not given; raises
    ``ValueError`` naming ``--device`` when the two disagree.  Nothing runs
    a plain version on the card, nor a kernel off it."""
    import torch

    kind = torch.device(args.device).type
    impl = args.impl or {v: k for k, v in _IMPL_DEVICE.items()}.get(kind)
    if impl is None or _IMPL_DEVICE[impl] != kind:
        raise ValueError(
            f"--impl {impl} runs on a {_IMPL_DEVICE.get(impl, '?')} device, "
            f"but --device is {args.device!r}: pass --device "
            f"{_IMPL_DEVICE.get(impl, 'cuda')} (or leave --impl out to "
            f"follow --device)")
    return impl


def _build_cfg(args):
    from repro_torch.core.types import LDAConfig

    buckets = tuple(sorted(_csv_ints(args.len_buckets)))
    if any(b % 8 for b in buckets):
        raise ValueError(f"--len-buckets must be multiples of 8: {buckets}")
    decay_tau0, decay_kappa = _parse_decay(args.decay)
    return LDAConfig(vocab_size=args.vocab, num_topics=args.topics,
                     lambda_w=args.lambda_w, lambda_k_abs=args.lambda_k,
                     inner_iters=args.inner_iters, residual_tol=args.tol,
                     decay_tau0=decay_tau0, decay_kappa=decay_kappa,
                     sync_dtype=args.sync_dtype, impl=resolve_impl(args),
                     sweep_policy=args.sweep_policy,
                     phi_acc_dtype=args.phi_acc_dtype,
                     onehot_crossover=args.onehot_crossover,
                     init_pad_len=buckets[-1]), buckets


@functools.lru_cache(maxsize=1)
def _topics(seed: int, vocab: int, topics: int):
    from repro_torch.data.synthetic import topic_cdf

    phi = np.random.default_rng(seed).dirichlet(
        np.full(vocab, 0.06), size=topics).astype(np.float32)
    cdf = topic_cdf(phi)
    phi.flags.writeable = cdf.flags.writeable = False
    return phi, cdf


def _true_phi(args):
    """One fixed ground-truth topic set for the whole stream, and its
    `topic_cdf` for fast draws (a pure function of seed, vocab and topics,
    kept for the process: at PUBMED width it is 282 M gamma draws)."""
    return _topics(args.seed, args.vocab, args.topics)


def synthetic_stream(args, buckets, start_m: int = 0):
    """The reference's resumable stream factory: batch m is drawn purely
    from (seed, m).  Yields (MiniBatch of CPU tensors, token count)."""
    from repro_torch.data.batching import bucket_len, docs_to_padded
    from repro_torch.data.synthetic import lda_corpus_from_phi

    phi, cdf = _true_phi(args)
    means = _csv_ints(args.doc_len_means)

    def gen():
        for m in range(start_m, args.minibatches):
            docs, _ = lda_corpus_from_phi(
                args.seed * 1_000_003 + m, args.docs_per_batch, phi,
                doc_len_mean=means[m % len(means)], cdf=cdf)
            nat = max(len(ids) for ids, _ in docs)
            L = buckets[-1] if args.fixed_len else bucket_len(nat, buckets)
            mb = docs_to_padded(docs, max_len=L)
            yield mb, float(mb.counts.sum())

    return gen


def _eval_split(args):
    """The reference's held-out split, drawn with a seed disjoint from every
    stream batch's."""
    from repro_torch.data.batching import (docs_to_padded,
                                           train_test_split_counts)
    from repro_torch.data.synthetic import lda_corpus_from_phi

    phi, cdf = _true_phi(args)
    docs, _ = lda_corpus_from_phi(args.seed * 1_000_003 + 987_654_321,
                                  args.eval_docs, phi, doc_len_mean=40,
                                  cdf=cdf)
    train, test = train_test_split_counts(docs, args.seed)
    return docs_to_padded(train), docs_to_padded(test)


def _state_tree(state) -> Dict[str, Any]:
    """The checkpoint payload, with the reference's keys; ``rng`` holds the
    torch generator's state (the reference holds a PRNG key there)."""
    return {"state": {"phi_acc": state.phi_acc, "m": np.int32(state.m),
                      "rng": state.generator.get_state()}}


def _run_signature(args) -> Dict[str, Any]:
    """The resume keys' values, ``impl`` resolved against ``--device``."""
    sig = {k: getattr(args, k) for k in _RESUME_KEYS}
    sig["impl"] = resolve_impl(args)
    return sig


def _jax_written_rng(directory: str) -> bool:
    """Whether the newest step's ``state/rng`` leaf is a JAX PRNG key
    (uint32 [2]), as the reference's driver writes it."""
    from repro_torch.dist import checkpoint as ckpt

    step = ckpt.latest_step(directory)
    try:
        with open(os.path.join(ckpt.step_dir(directory, step),
                               "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
    except Exception:  # noqa: BLE001 — an unreadable step says nothing
        return False
    return any(rec["key"] == "['state']['rng']" and rec["dtype"] == "uint32"
               and rec["shape"] == [2] for rec in leaves)


def _warmup_batches(args, buckets, cfg):
    """What the warm-up pushes through the step: an all-padding [D, L]
    batch of each length bucket (they stop at t = 1), and one batch of the
    smallest bucket with every slot counted, for a step that runs one
    selective iteration (the policy's selective kernels)."""
    import torch

    D = args.docs_per_batch
    pads = [(torch.zeros((D, L), dtype=torch.int32),
             torch.zeros((D, L), dtype=torch.float32))
            for L in (buckets[-1:] if args.fixed_len else buckets)]
    L = pads[0][0].shape[1]
    ids = (torch.arange(D * L, dtype=torch.int32) % cfg.vocab_size
           ).reshape(D, L)
    return pads, (ids, torch.ones((D, L), dtype=torch.float32))


def train_loop(args) -> Dict[str, Any]:
    """Run the driver; returns a result dict (see the end)."""
    import dataclasses

    import torch

    from repro_torch.core import perplexity
    from repro_torch.core.device import resolve_device
    from repro_torch.core.pobp import (DiagBuffer, init_train_state,
                                       make_train_step)
    from repro_torch.core.types import LDATrainState
    from repro_torch.data.batching import prefetched
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import launch_counts

    _reject_unported(args)
    if args.crash_at and not args.ckpt_dir:
        raise ValueError("--crash-at needs --ckpt-dir: without a checkpoint "
                         "the rerun restarts from scratch and hits the same "
                         "simulated failure forever")
    if args.crash_at and args.ckpt_dir and args.crash_at <= args.ckpt_every:
        print(f"[warn] --crash-at {args.crash_at} fires before the first "
              f"checkpoint (--ckpt-every {args.ckpt_every}); the rerun will "
              f"restart from scratch and crash again", flush=True)
    cfg, buckets = _build_cfg(args)
    dev = resolve_device(args.device)
    step, meter = make_train_step(cfg, 1, args.sync, args.sync_dtype,
                                  device=dev)
    state = init_train_state(cfg, args.seed, device=dev)
    signature = _run_signature(args)
    start_m = 0
    if args.ckpt_dir:
        if ckpt.latest_step(args.ckpt_dir) is not None and \
                _jax_written_rng(args.ckpt_dir):
            raise ValueError(
                f"checkpoint in {args.ckpt_dir} was written by the JAX "
                f"package: its state/rng leaf is a JAX PRNG key, which "
                f"cannot be resumed here (torch draws from a generator); "
                f"carry its phi_acc and m over with "
                f"convert.train_state_from_reference and a seed, or use a "
                f"fresh --ckpt-dir")
        try:
            got = ckpt.restore_latest(args.ckpt_dir, _state_tree(state),
                                      grow_rows=("phi_acc",),
                                      cast_dtypes=("phi_acc",))
        except ValueError as e:
            raise ValueError(
                f"cannot restore checkpoint from {args.ckpt_dir} ({e}); it "
                f"was probably written by an older/other tool — use a fresh "
                f"--ckpt-dir") from e
        if got is not None:
            trees, extra, ck_step = got
            for key, saved in extra.get("run", {}).items():
                if key in signature and saved != signature[key]:
                    raise ValueError(
                        f"checkpoint in {args.ckpt_dir} was written with "
                        f"{key}={saved!r} but this run has "
                        f"{key}={signature[key]!r}; rerun with matching "
                        f"flags or a fresh --ckpt-dir")
            saved = trees["state"]
            state.generator.set_state(saved["rng"])
            state = LDATrainState(phi_acc=saved["phi_acc"],
                                  m=int(saved["m"]),
                                  generator=state.generator)
            start_m = int(extra["next_m"])
            print(f"[restore] resumed from checkpoint step {ck_step} -> "
                  f"next minibatch {start_m + 1}", flush=True)
            if start_m >= args.minibatches:
                print(f"[restore] checkpoint already covers all "
                      f"{args.minibatches} minibatches — nothing to train "
                      f"(raise --minibatches or use a fresh --ckpt-dir)",
                      flush=True)

    warmup_s, warmup_launches = 0.0, {}
    if args.warmup_buckets:
        # the first launch of every kernel (the port's counterpart of the
        # reference's compile) on a throwaway state with its own generator:
        # the run's draws and result are untouched
        t0 = time.time()
        before = launch_counts()
        pads, full = _warmup_batches(args, buckets, cfg)
        scratch = init_train_state(cfg, args.seed, device=dev)
        for ids, cnt in pads:
            scratch, _ = step(scratch, ids, cnt)
        once, _ = make_train_step(
            dataclasses.replace(cfg, inner_iters=2, residual_tol=-1.0), 1,
            args.sync, args.sync_dtype, device=dev)
        scratch, _ = once(scratch, *full)
        del scratch
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warmup_s = time.time() - t0
        warmup_launches = {k: n - before[k]
                           for k, n in launch_counts().items()}
    eval_split = None

    def eval_ppl() -> float:
        nonlocal eval_split
        if eval_split is None:
            eval_split = _eval_split(args)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        return perplexity.evaluate(state.phi_acc, *eval_split, cfg,
                                   generator=gen, device=dev)

    buf = DiagBuffer(block=max(args.log_every, 64))
    ppl_trace = []
    tokens = 0.0
    t0 = time.time()
    stream = prefetched(synthetic_stream(args, buckets, start_m),
                        args.prefetch)
    for m, (batch, ntok) in enumerate(stream, start=start_m):
        state, diag = step(state, batch.word_ids, batch.counts)
        buf.append(diag["mean_r"], diag["iters"])
        tokens += ntok
        step_no = m + 1
        if args.log_every and step_no % args.log_every == 0:
            dt = time.time() - t0
            print(f"minibatch {step_no:5d}  "
                  f"mean_r={float(diag['mean_r']):.4f}"
                  f"  iters={int(diag['iters']):3d}"
                  f"  tokens/s={tokens / max(dt, 1e-9):,.0f}", flush=True)
        if args.eval_every and step_no % args.eval_every == 0:
            ppl = eval_ppl()
            ppl_trace.append((step_no, ppl))
            print(f"minibatch {step_no:5d}  held-out ppl={ppl:.2f}",
                  flush=True)
        if args.crash_at and step_no == args.crash_at and start_m == 0:
            # fresh runs only: a resumed run sails past the simulated
            # failure, so rerunning the same command completes
            raise SystemExit(f"[simulated crash] after minibatch {step_no}")
        if args.ckpt_dir and args.ckpt_every and \
                step_no % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step_no, _state_tree(state),
                      extra={"next_m": step_no, "run": signature})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    rows = buf.rows()
    iters = [int(i) for _, i in rows]
    return {
        "first_m": start_m,
        "mean_r": [float(r) for r, _ in rows],
        "iters": iters,
        "len_buckets": list(buckets),
        "tokens": tokens,
        "wall_s": wall,
        "warmup_s": warmup_s,
        "warmup_launches": warmup_launches,
        "tokens_per_s": tokens / max(wall, 1e-9),
        "ppl": eval_ppl(),
        "ppl_trace": ppl_trace,
        "bytes_by_phase": dict(meter.bytes_by_phase),
        "per_minibatch_bytes": (meter.per_minibatch_bytes(iters[-1])
                                if iters else 0),
        "phi_acc": state.phi_acc.cpu(),
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = train_loop(args)
    print(f"[done] {args.minibatches - res['first_m']} minibatches  final "
          f"mean_r={res['mean_r'][-1] if res['mean_r'] else float('nan'):.4f}"
          f"  held-out ppl={res['ppl']:.2f}")
    print(f"[perf] tokens/s={res['tokens_per_s']:,.0f}  "
          f"(buckets={res['len_buckets']})  warmup={res['warmup_s']:.1f}s  "
          f"wall={res['wall_s']:.1f}s")
    print(f"[comm] per-minibatch bytes={res['per_minibatch_bytes']:,} "
          f"(phases: {res['bytes_by_phase']})")
    return res


if __name__ == "__main__":
    main()
