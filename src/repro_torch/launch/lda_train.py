"""Streaming POBP training driver of the port (counterpart of
``repro.launch.lda_train``): the paper's Fig. 4 outer loop.

The fixed-vocabulary path of the reference driver, with its flag names,
its synthetic stream (batch m drawn from (seed, m) off one fixed
ground-truth topic set, L snapped to ``--len-buckets``) and its held-out
split.  Each batch runs one step; the host reads the diagnostics every
``--log-every`` batches.  ``--eval-every`` scores held-out perplexity
through ``core.perplexity.evaluate``; ``--ckpt-dir``/``--ckpt-every`` save
checkpoints in the reference's format (``dist/checkpoint.save``), so
``launch/serve.py`` of either package can serve them.  ``--device``
(default ``cuda``) picks the card or, when asked, the CPU.

  PYTHONPATH=src python -m repro_torch.launch.lda_train --minibatches 8 \\
      --docs-per-batch 32 --vocab 300 --topics 16 --lambda-k 8 \\
      --eval-every 4 --ckpt-dir /tmp/lda_ck --ckpt-every 4 --device cuda

Execution, as the reference's: ``--backend sim`` (the default) runs
``--shards`` data shards (default 4, the reference's) in lockstep on one
device (``core.pobp.make_train_step``); ``--backend shard_map`` runs one
process a position of a ``DeviceMesh`` (``--mesh single|multi``, or
``--mesh-shape data,model`` / ``pod,data,model``), documents split over
the data axes and topics over the model axis (``core.pobp.
shard_map_minibatch_fn``).  One command starts the whole mesh: the
driver builds the CUDA kernels, spawns a process a rank, and returns rank
0's result; rank 0 alone prints, and it alone writes checkpoints, of the
global [W, K] phi_acc; on resume each rank restores its columns.
``--dist-backend`` names the collective transport (default ``nccl`` with
a CUDA ``--device``, ``gloo`` with ``--device cpu``); NCCL refuses two
ranks on one card, so a mesh larger than the card count asks for
``gloo``.

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

Dynamic vocabulary and the stream lifecycle, as the reference's
(``--backend sim`` only, as there): ``--dynamic-vocab`` draws a drifting
stream (``--drift-mode grow``: ``--vocab`` words plus
``--vocab-growth-per-batch`` a batch; ``slide``: a window of ``--vocab``
words sliding by that many a batch), maps its external word keys to phi
rows through a ``VocabMap`` and holds phi_acc on the capacity ladder
(``--w-cap-min``, ``--w-growth``); a batch whose live vocabulary reaches
the rung grows the state (guard rows padded on), rebuilds and rewarms the
step and checkpoints (``[grow]``).  ``--decay tau0,kappa`` fades the
statistic; ``--compact-every N`` adds a checkpoint fence every N batches
(``[compact]``): the stream is drained, rows idle for
``--compact-min-idle`` batches whose mass is at or under
``--compact-mass-tol`` x K x beta are reclaimed (``VocabMap.compact``, the
remap applied on the device), topics whose mass faded under
``--recycle-tol`` are reseeded, a rung the vocabulary no longer needs is
dropped, and the state is saved with its vocabulary and remap.  The
checkpoint's ``dyn`` extra (rung, live size, keys, touch stamps, version,
remap) is read before the restore template is built, so a run resumes on
the rung it saved.

The parameter server, as the reference's (``--backend ps``, DESIGN.md
§15): the same step (``--shards`` lockstep shards, one worker) under the
server's wire model (``core.sync.PSReducer``); ``dist.paramserver`` holds
the authoritative [W, K] statistic on the host in ``--ps-servers``
row-range shards.  Before each batch the worker pulls the rows the batch
touches into its replica on the device, after it pushes their delta;
``--staleness S`` lets a pull miss the last S pushes (S = 0 follows
``--backend sim``), ``--ps-latency`` delays each op, ``--ps-pull-timeout``
bounds a pull's wait.  Each checkpoint fence drains the pipeline and
adopts the server's phi.  ``--chaos-*`` injects a seeded fault schedule
(``dist.faults``: drops, duplicates, delays, one server crash and
restart), which the client's retries and replay survive bit for bit at
S = 0 (DESIGN.md §17); ``--elastic-workers`` / ``--elastic-events`` let
logical workers join, leave or crash mid-batch (a survivor replays the
batch).  The run reports the measured wire bytes, the waits and the
fault counters (``[ps]``, ``[chaos]``, ``[elastic]``).  Every flag of the
reference's parser runs here or is refused as the reference refuses it.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

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
# ps_latency, ps_pull_timeout and the chaos and elastic flags are not
# resume keys: latency changes the wall clock only, faults are retried and
# replayed to the same committed state, and elastic membership at S = 0
# only changes which client pushes a batch
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
    ap.add_argument("--vocab", type=int, default=500,
                    help="vocabulary size (dynamic mode: the initial external "
                         "vocabulary of the drifting stream, or with "
                         "--drift-mode slide its window)")
    ap.add_argument("--topics", type=int, default=16)
    ap.add_argument("--dynamic-vocab", action="store_true",
                    help="a drifting stream: external keys map to phi rows "
                         "through a VocabMap and phi grows along the "
                         "capacity ladder (--backend sim only)")
    ap.add_argument("--vocab-growth-per-batch", type=int, default=24,
                    help="external words entering the stream a mini-batch "
                         "(--drift-mode slide: also the words retired)")
    ap.add_argument("--drift-mode", default="grow", choices=["grow", "slide"],
                    help="'grow': the vocabulary only accretes; 'slide': a "
                         "window of --vocab words slides each batch")
    ap.add_argument("--decay", default="1,0",
                    help="Robbins-Monro forgetting 'tau0,kappa' on the phi "
                         "fold; kappa=0 disables")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="a checkpoint-fenced compaction every N mini-batches "
                         "(0: never; --dynamic-vocab only)")
    ap.add_argument("--compact-min-idle", type=int, default=5,
                    help="batches a row must be untouched to be reclaimed")
    ap.add_argument("--compact-mass-tol", type=float, default=25.0,
                    help="dead-mass floor in units of K*beta: an idle row "
                         "dies when its statistic <= tol*K*beta")
    ap.add_argument("--recycle-tol", type=float, default=0.0,
                    help="at each fence, reseed topics whose live mass <= "
                         "tol x the mean topic mass (0: never)")
    ap.add_argument("--w-cap-min", type=int, default=64,
                    help="first W capacity rung")
    ap.add_argument("--w-growth", type=float, default=2.0,
                    help="geometric W ladder factor")
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
    ap.add_argument("--shards", type=int, default=4,
                    help="data shards in lockstep on one device "
                         "(--backend sim)")
    ap.add_argument("--backend", default="sim",
                    choices=["sim", "shard_map", "ps"],
                    help="sim: --shards in lockstep on one device; "
                         "shard_map: a process a mesh position; ps: the "
                         "sim step as one worker of a parameter server")
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded staleness S of --backend ps: a pull for "
                         "mini-batch m may miss the last S pushes; S=0 "
                         "barriers every pull behind the previous push "
                         "(the trajectory of --backend sim)")
    ap.add_argument("--ps-servers", type=int, default=4,
                    help="row-range server shards (--backend ps)")
    ap.add_argument("--ps-latency", type=float, default=0.0,
                    help="delay in seconds injected into each transport op "
                         "(--backend ps)")
    ap.add_argument("--ps-pull-timeout", type=float, default=60.0,
                    help="seconds a pull waits server-side before a "
                         "TimeoutError names the shard and version; the "
                         "client's retry deadline is twice this")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-plan seed: the same run replays the same "
                         "drop/dup/delay decisions")
    ap.add_argument("--chaos-drop", type=float, default=0.0,
                    help="drop probability of each push and pull op (< 1)")
    ap.add_argument("--chaos-dup", type=float, default=0.0,
                    help="duplicate-delivery probability of each push")
    ap.add_argument("--chaos-delay", type=float, default=0.0,
                    help="issue-side delay in seconds when a delay fires")
    ap.add_argument("--chaos-delay-prob", type=float, default=0.0,
                    help="probability of --chaos-delay on each op")
    ap.add_argument("--chaos-crash", default="",
                    help="server loss as SERVER@PUSHOP (e.g. '1@6'): the "
                         "shard crashes at that push op, restarts "
                         "--chaos-restart-after ops later and recovers "
                         "from the last synced snapshot and the client's "
                         "replay")
    ap.add_argument("--chaos-restart-after", type=int, default=2,
                    help="push ops between the crash and the restart")
    ap.add_argument("--elastic-workers", default="w0",
                    help="comma-separated logical worker ids, each a "
                         "PSClient over the shared transport; mini-batch m "
                         "goes to active[m %% len(active)]")
    ap.add_argument("--elastic-events", default="",
                    help="membership events 'join:NAME@M', 'leave:NAME@M', "
                         "'crash:NAME@M' at 0-based mini-batch M; a crashed "
                         "worker's batch is replayed by a survivor")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"],
                    help="production mesh for --backend shard_map: (16, 16) "
                         "data x model, or (2, 16, 16) pod x data x model")
    ap.add_argument("--mesh-shape", default="",
                    help="the mesh as 'data,model' or 'pod,data,model' "
                         "instead, e.g. --mesh-shape 2,2")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="collective transport of --backend shard_map "
                         "(default: nccl with a CUDA --device, gloo with "
                         "--device cpu; gloo runs several ranks on one "
                         "card, NCCL refuses that)")
    return ap


def default_args(**overrides) -> argparse.Namespace:
    """Programmatic entry: the parser's defaults with keyword overrides."""
    args = build_parser().parse_args([])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise TypeError(f"unknown driver arg: {k}")
        setattr(args, k, v)
    return args


def _csv_ints(s: str):
    return tuple(int(x) for x in str(s).split(",") if str(x).strip())


def _parse_decay(s: str):
    parts = [p.strip() for p in str(s).split(",")]
    if len(parts) != 2:
        raise ValueError(f"--decay expects 'tau0,kappa', got {s!r}")
    return float(parts[0]), float(parts[1])


def _parse_elastic_events(spec: str) -> Dict[int, list]:
    """``"join:w1@4,leave:w0@8,crash:w1@12"`` -> {batch index: [(kind,
    name), ...]}, applied at that 0-based mini-batch (DESIGN.md §17)."""
    events: Dict[int, list] = {}
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            kind, rest = tok.split(":")
            name, at = rest.split("@")
            at = int(at)
        except ValueError:
            raise ValueError(f"bad --elastic-events entry {tok!r}; expected "
                             f"kind:NAME@M (e.g. 'join:w1@4')") from None
        if kind not in ("join", "leave", "crash"):
            raise ValueError(f"unknown elastic event kind {kind!r} in "
                             f"{tok!r} (join/leave/crash)")
        events.setdefault(at, []).append((kind, name))
    return events


def _with_lookahead(it):
    """Pair each stream item with its successor (None at the end), so the
    parameter-server client can prefetch the next batch's rows while the
    current step runs."""
    prev = None
    for item in it:
        if prev is not None:
            yield prev, item
        prev = item
    if prev is not None:
        yield prev, None


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


def _build_cfg(args, vocab_size: Optional[int] = None):
    from repro_torch.core.types import LDAConfig

    buckets = tuple(sorted(_csv_ints(args.len_buckets)))
    if any(b % 8 for b in buckets):
        raise ValueError(f"--len-buckets must be multiples of 8: {buckets}")
    decay_tau0, decay_kappa = _parse_decay(args.decay)
    return LDAConfig(vocab_size=vocab_size or args.vocab,
                     num_topics=args.topics,
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


@functools.lru_cache(maxsize=1)
def _score_cache(seed: int, topics: int) -> dict:
    """The drifting streams' word scores (and last window cdf) for the
    process: a pure function of (seed, topics), grown as the stream asks;
    at PUBMED width the scores alone are ~30 s of gamma draws."""
    return {}


def drifting_stream(args, buckets, start_m: int, vocab,
                    end_m: Optional[int] = None):
    """The reference's drifting-vocabulary stream factory.

    ``--drift-mode grow``: batch m draws from the first ``vocab + growth *
    m`` external words; ``slide``: from the window ``[growth * m, growth *
    m + vocab)``.  Each batch's keys are admitted through ``vocab`` in
    generation order, stamping the rows as touched at m, and the live size
    is read right after, so it does not depend on how far the prefetch runs
    ahead; a resumed run re-admits the saved prefix's keys as no-ops.  The
    generator stops before ``end_m`` (a compaction fence), so nothing is
    admitted or touched past the fence.  Yields (MiniBatch of CPU tensors,
    token count, live_w)."""
    from repro_torch.data.batching import bucket_len, docs_to_padded
    from repro_torch.data.synthetic import (drifting_news_stream,
                                            drifting_vocab_docs)

    means = _csv_ints(args.doc_len_means)
    cache = _score_cache(args.seed, args.topics)
    stop = args.minibatches if end_m is None else end_m
    slide = args.drift_mode == "slide"

    def gen():
        for m in range(start_m, stop):
            if slide:
                docs, _ = drifting_news_stream(
                    args.seed, m, args.docs_per_batch, args.vocab,
                    args.vocab_growth_per_batch, args.topics,
                    doc_len_mean=means[m % len(means)], score_cache=cache)
            else:
                docs, _ = drifting_vocab_docs(
                    args.seed, m, args.docs_per_batch,
                    args.vocab + args.vocab_growth_per_batch * m,
                    args.topics, doc_len_mean=means[m % len(means)],
                    score_cache=cache)
            docs = vocab.map_docs(docs, admit=True, step=m)
            live = vocab.live
            nat = max(len(ids) for ids, _ in docs)
            L = buckets[-1] if args.fixed_len else bucket_len(nat, buckets)
            mb = docs_to_padded(docs, max_len=L)
            yield mb, float(mb.counts.sum()), live

    return gen


def _eval_split_dynamic(args):
    """Held-out documents of the growing stream in EXTERNAL key space, from
    the batch-0 vocabulary with a disjoint batch counter (the training
    vocabulary is never touched); each evaluation maps them through the
    vocabulary, unseen words to the first guard row."""
    from repro_torch.data.batching import train_test_split_counts
    from repro_torch.data.synthetic import drifting_vocab_docs

    docs, _ = drifting_vocab_docs(args.seed, 987_654_321, args.eval_docs,
                                  args.vocab, args.topics, doc_len_mean=40,
                                  score_cache=_score_cache(args.seed,
                                                           args.topics))
    return train_test_split_counts(docs, args.seed)


def _eval_split_slide(args, m: int):
    """Held-out documents of the sliding stream: an independent set
    (``heldout=True``) from the window batch ``m`` trained on, so the
    held-out set drifts with the stream."""
    from repro_torch.data.batching import train_test_split_counts
    from repro_torch.data.synthetic import drifting_news_stream

    docs, _ = drifting_news_stream(args.seed, m, args.eval_docs, args.vocab,
                                   args.vocab_growth_per_batch, args.topics,
                                   doc_len_mean=40, heldout=True,
                                   score_cache=_score_cache(args.seed,
                                                            args.topics))
    return train_test_split_counts(docs, args.seed)


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


def _warmup_batches(args, buckets, cfg, shards: int = 1, words=None):
    """What the warm-up pushes through the step: an all-padding [D, L]
    batch of each length bucket (they stop at t = 1), and one batch of the
    smallest bucket with every slot counted, for a step that runs one
    selective iteration (the policy's selective kernels), its word ids
    cycling over ``words`` (default: the vocabulary); stacked [N, D/N, L]
    for ``shards`` data shards."""
    import torch

    D = args.docs_per_batch
    pads = [(torch.zeros((D, L), dtype=torch.int32),
             torch.zeros((D, L), dtype=torch.float32))
            for L in (buckets[-1:] if args.fixed_len else buckets)]
    L = pads[0][0].shape[1]
    ids = (torch.arange(D * L, dtype=torch.int32) % (words or cfg.vocab_size)
           ).reshape(D, L)
    full = (ids, torch.ones((D, L), dtype=torch.float32))
    if shards > 1:
        pads, full = ([tuple(x.reshape(shards, -1, x.shape[1]) for x in p)
                       for p in pads],
                      tuple(x.reshape(shards, D // shards, L) for x in full))
    return pads, full


def _mesh_dims(args):
    """(shape, axis names) of the ``--backend shard_map`` mesh."""
    if args.mesh_shape:
        dims = _csv_ints(args.mesh_shape)
        if len(dims) not in (2, 3):
            raise ValueError(f"--mesh-shape takes 'data,model' or "
                             f"'pod,data,model', got {args.mesh_shape!r}")
        return dims, (("data", "model") if len(dims) == 2
                      else ("pod", "data", "model"))
    if args.mesh == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_shardmap_train_step(cfg, mesh, sync_mode="power",
                             sync_dtype="float32"):
    """The driver's step on a mesh, one rank a position: the state holds
    this rank's topic columns of phi_acc [W, K/M]; ``step(state, word_ids
    [D, L], counts)`` runs this rank's documents through
    ``core.pobp.shard_map_minibatch_fn``.  The same contract as
    ``core.pobp.make_train_step`` (theta is not gathered: None)."""
    import torch

    from repro_torch.core import quantize
    from repro_torch.core.pobp import (_decay_factor, _delta_weight,
                                       _sr_generator, shard_map_minibatch_fn)
    from repro_torch.core.types import LDATrainState

    with_decay = bool(cfg.decay_kappa)
    fn, meter = shard_map_minibatch_fn(cfg, mesh, sync_mode, sync_dtype,
                                       with_decay=with_decay)
    storage = quantize.phi_acc_dtype(cfg)

    def step(state, word_ids, counts, *, u0=None):
        m = state.m + 1
        extra = (_decay_factor(cfg, m),) if with_decay else ()
        phi, iters, mean_r = fn(word_ids, counts, state.phi_acc,
                                _delta_weight(cfg, m), *extra,
                                generator=state.generator, u0=u0)
        if storage != torch.float32:
            phi = quantize.stochastic_round(
                phi, storage, _sr_generator(state.generator, m))
        return (LDATrainState(phi_acc=phi, m=m, generator=state.generator),
                dict(iters=iters, mean_r=mean_r, theta=None))

    return step, meter


# the CUDA sources of the training path, built once before a mesh's ranks
# start (ranks building into one directory would race)
_SOURCES = ("power_sweep_carry", "bp_update", "power_pack",
            "power_sweep_tokens", "segment_sum")


def _run_mesh(args) -> Dict[str, Any]:
    """Start one process a position of the ``--backend shard_map`` mesh,
    each running `train_loop` inside an initialized process group, and
    return rank 0's result with every rank's ``iters`` and ``mean_r``
    under ``ranks``.  A simulated crash (``--crash-at``) in the ranks ends
    this call by ``SystemExit`` too."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as tmp_mp

    from repro_torch.core.device import resolve_device

    dims, _ = _mesh_dims(args)
    world = int(np.prod(dims))
    dev = resolve_device(args.device)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("--dist-backend nccl needs --device cuda; pass "
                             "--dist-backend gloo to run the mesh on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"the mesh {dims} needs {world} ranks and NCCL refuses two "
                f"ranks on one card ({cards} card(s) here); pass "
                f"--dist-backend gloo to run them on {cards} card(s)")
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(_SOURCES)
    out = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        tmp_mp.start_processes(_mesh_rank, args=(args, world, backend, out),
                               nprocs=world, join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    crash = next((r["crash"] for r in ranks if "crash" in r), None)
    if crash is not None:
        raise SystemExit(crash)
    res = ranks[0]
    res["ranks"] = [{k: r[k] for k in ("iters", "mean_r", "launches")}
                    for r in ranks]
    res["dist_backend"] = backend
    return res


def _mesh_rank(rank: int, args, world: int, backend: str, out: str) -> None:
    """One rank of `_run_mesh`: join the process group (a file store in
    ``out``), run `train_loop`, save the result (rank 0's whole; the
    others' diagnostics and kernel launches) to ``out``."""
    import datetime
    import sys

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts

    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{out}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        try:
            res = train_loop(args)
        except SystemExit as e:
            res = {"crash": str(e)}
        res["launches"] = launch_counts()
        if rank:
            res = {k: res[k] for k in ("iters", "mean_r", "launches",
                                       "crash") if k in res}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _check_flags(args):
    """The reference's refusals of the dynamic, lifecycle, parameter-server,
    chaos and elastic flags, word for word and in its order.  Returns
    (dynamic vocabulary, chaos on, elastic events, worker ids)."""
    dynamic = bool(args.dynamic_vocab)
    if dynamic and args.backend != "sim":
        raise ValueError("--dynamic-vocab currently requires --backend sim "
                         "(shard_map growth is on the ROADMAP backlog)")
    ps = args.backend == "ps"
    if ps and _parse_decay(args.decay)[1]:
        raise ValueError("--backend ps with --decay kappa>0 is not supported "
                         "yet: RM forgetting rescales EVERY phi row each "
                         "batch, so a touched-row delta push would silently "
                         "drop the decay on untouched server rows "
                         "(per-segment decay billing rides the multi-host "
                         "backlog item, ROADMAP)")
    chaos_on = bool(args.chaos_drop or args.chaos_dup
                    or args.chaos_delay_prob or args.chaos_crash)
    elastic_events = _parse_elastic_events(args.elastic_events)
    workers = [w.strip() for w in args.elastic_workers.split(",")
               if w.strip()] or ["w0"]
    if len(set(workers)) != len(workers):
        raise ValueError(f"duplicate --elastic-workers ids: {workers}")
    if not ps and (chaos_on or elastic_events or workers != ["w0"]):
        raise ValueError("--chaos-* and --elastic-* flags require "
                         "--backend ps (DESIGN.md §17)")
    if elastic_events and args.staleness != 0:
        raise ValueError("--elastic-events requires --staleness 0: crash "
                         "replay parity holds only when every pull reflects "
                         "every prior push (DESIGN.md §17)")
    if args.chaos_crash and (len(workers) > 1 or elastic_events):
        raise ValueError(
            "--chaos-crash with multiple/elastic workers is unsupported: "
            "shard recovery replays the RETAINED LOG OF ONE CLIENT, so a "
            "multi-writer shard would come back missing the other "
            "clients' post-fence deltas (DESIGN.md §17 records this "
            "limitation; use a single worker for server-crash chaos)")
    if args.compact_every and not dynamic:
        raise ValueError("--compact-every needs --dynamic-vocab: a fixed-W "
                         "run has no VocabMap to compact (DESIGN.md §14)")
    return dynamic, chaos_on, elastic_events, workers


def train_loop(args) -> Dict[str, Any]:
    """Run the driver; returns a result dict (see the end).  With
    ``--backend shard_map`` and no process group yet, starts the mesh
    (`_run_mesh`); inside one, runs this rank."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core import lifecycle, perplexity
    from repro_torch.core.device import resolve_device
    from repro_torch.core.pobp import (DiagBuffer, init_train_state,
                                       make_train_step, mesh_data_index)
    from repro_torch.core.sync import (CommMeter, LocalReducer, PSReducer,
                                       SimReducer)
    from repro_torch.core.types import LDATrainState
    from repro_torch.data.batching import (docs_to_padded, prefetched,
                                           stack_shards)
    from repro_torch.data.vocab import VocabMap, next_capacity
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import launch_counts

    dynamic, chaos_on, elastic_events, worker_names = _check_flags(args)
    ps = args.backend == "ps"
    if args.backend == "shard_map" and not dist.is_initialized():
        return _run_mesh(args)
    if args.crash_at and not args.ckpt_dir:
        raise ValueError("--crash-at needs --ckpt-dir: without a checkpoint "
                         "the rerun restarts from scratch and hits the same "
                         "simulated failure forever")
    compact_every = int(args.compact_every or 0)

    # dynamic mode: the rung must be known before the restore template is
    # built, so the newest manifest's extra is read first
    vocab = VocabMap()
    live_done = 0            # live vocabulary as of the last consumed batch
    vocab_version = 0        # one more at every fence that reclaims rows
    last_remap = None        # the latest fence's row remap
    w_cap = next_capacity(0, 0, args.w_cap_min, args.w_growth)
    if dynamic and args.ckpt_dir:
        peeked = ckpt.peek_extra(args.ckpt_dir)
        if peeked is not None and "dyn" in peeked[0]:
            dyn = peeked[0]["dyn"]
            w_cap = int(dyn["w_cap"])
            live_done = int(dyn["live_w"])
            vocab = VocabMap(dyn["vocab_keys"],
                             touched=dyn.get("touched", ()))
            vocab_version = int(dyn.get("vocab_version", 0))
            last_remap = dyn.get("row_remap")

    cfg, buckets = _build_cfg(args, vocab_size=w_cap if dynamic else None)
    dev = resolve_device(args.device)
    shards = args.shards if args.backend in ("sim", "ps") else 1
    if shards < 1 or args.docs_per_batch % shards:
        raise ValueError(f"--docs-per-batch {args.docs_per_batch} does not "
                         f"divide over --shards {shards}")
    mesh, rank0, gather_group = None, True, None
    W, K = cfg.vocab_size, cfg.num_topics
    cols = slice(0, K)
    if args.backend == "shard_map":
        from repro_torch.launch.mesh import make_mesh

        dims, axes = _mesh_dims(args)
        mesh = make_mesh(dims, axes, dev.type)
        if K % dims[-1]:
            raise ValueError(f"--topics {K} does not divide over the "
                             f"model axis of {dims[-1]}")
        Kl = K // dims[-1]
        m_index = mesh.get_coordinate()[axes.index("model")]
        cols = slice(m_index * Kl, (m_index + 1) * Kl)
        rank0 = dist.get_rank() == 0
        # the data shard 0 ranks gather the global phi_acc for rank 0
        if mesh_data_index(mesh)[0] == 0:
            gather_group = mesh.get_group("model")
    if args.crash_at and args.ckpt_dir and args.crash_at <= args.ckpt_every \
            and rank0:
        print(f"[warn] --crash-at {args.crash_at} fires before the first "
              f"checkpoint (--ckpt-every {args.ckpt_every}); the rerun will "
              f"restart from scratch and crash again", flush=True)

    def build_step(c):
        if ps:
            # the sim step as one worker under the server's wire model:
            # every vocabulary-row payload billed as a touched-row push and
            # pull (the host-side exchange is the PSClient below)
            meter = CommMeter()
            inner = (LocalReducer(meter=meter, sync_dtype=args.sync_dtype)
                     if shards == 1 else
                     SimReducer(shards, meter=meter,
                                sync_dtype=args.sync_dtype))
            return make_train_step(c, shards, args.sync, args.sync_dtype,
                                   reducer=PSReducer(inner), device=dev)
        if mesh is None:
            return make_train_step(c, shards, args.sync, args.sync_dtype,
                                   device=dev)
        return make_shardmap_train_step(c, mesh, args.sync, args.sync_dtype)

    def fresh_state(c):
        st = init_train_state(c, args.seed, device=dev)
        if mesh is not None:
            st = LDATrainState(phi_acc=st.phi_acc[:, cols].contiguous(),
                               m=0, generator=st.generator)
        return st

    def global_phi(phi):
        """The global [W, K] phi_acc (collective on the data shard 0
        ranks; None elsewhere)."""
        if mesh is None:
            return phi
        if gather_group is None:
            return None
        full = phi.new_zeros((W, K))
        full[:, cols] = phi
        dist.all_reduce(full, group=gather_group)
        return full

    def sync_device():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step, meter = build_step(cfg)
    state = fresh_state(cfg)
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
        template = LDATrainState(
            phi_acc=(state.phi_acc if mesh is None
                     else state.phi_acc.new_zeros((W, K))),
            m=0, generator=state.generator)
        try:
            got = ckpt.restore_latest(args.ckpt_dir, _state_tree(template),
                                      grow_rows=("phi_acc",),
                                      cast_dtypes=("phi_acc",))
        except ValueError as e:
            raise ValueError(
                f"cannot restore checkpoint from {args.ckpt_dir} ({e}); it "
                f"was probably written by an older/other tool — use a fresh "
                f"--ckpt-dir") from e
        del template
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
            state = LDATrainState(
                phi_acc=saved["phi_acc"][:, cols].contiguous(),
                m=int(saved["m"]), generator=state.generator)
            del trees, saved
            start_m = int(extra["next_m"])
            if rank0:
                print(f"[restore] resumed from checkpoint step {ck_step} -> "
                      f"next minibatch {start_m + 1}", flush=True)
            if start_m >= args.minibatches and rank0:
                print(f"[restore] checkpoint already covers all "
                      f"{args.minibatches} minibatches — nothing to train "
                      f"(raise --minibatches or use a fresh --ckpt-dir)",
                      flush=True)

    ps_server = ps_transport = None
    ps_workers: Dict[str, Any] = {}
    ps_active: list = []
    ps_retired: list = []       # left or crashed workers, kept for stats
    elastic_log: list = []
    if ps:
        from repro_torch.dist.faults import ChaosTransport, FaultPlan
        from repro_torch.dist.paramserver import (ParamServer, PSClient,
                                                  SimTransport,
                                                  touched_rows_of)
        # the server group holds the authoritative statistic; a resumed run
        # rehydrates it from the restored state at version start_m (the
        # checkpoint holds the server's phi, see ps_sync_state)
        ps_server = ParamServer(state.phi_acc.float().cpu().numpy(),
                                num_servers=args.ps_servers,
                                version=start_m,
                                pull_timeout=args.ps_pull_timeout)
        ps_transport = SimTransport(ps_server, latency_s=args.ps_latency,
                                    wire_dtype=args.sync_dtype)
        if chaos_on:
            crash_server, crash_at = FaultPlan.parse_crash(args.chaos_crash)
            ps_transport = ChaosTransport(ps_transport, FaultPlan(
                seed=args.chaos_seed, drop_push=args.chaos_drop,
                drop_pull=args.chaos_drop, dup_push=args.chaos_dup,
                delay_s=args.chaos_delay, delay_prob=args.chaos_delay_prob,
                crash_server=crash_server, crash_at_push=crash_at,
                restart_after_pushes=args.chaos_restart_after))

        def make_worker(name: str) -> PSClient:
            return PSClient(ps_transport, staleness=args.staleness,
                            client_id=name,
                            retry_deadline_s=2.0 * args.ps_pull_timeout,
                            meter=meter)

        ps_workers = {name: make_worker(name) for name in worker_names}
        ps_active = list(worker_names)

    def ps_sync_state() -> None:
        """Drain the pipeline and adopt the server's phi as the state, in
        the state's dtype (fences and the end of the stream); the snapshot
        becomes the crash-recovery base, so every worker trims its replay
        log."""
        nonlocal state
        for w in ps_workers.values():
            w.flush()
        phi_srv, _ = ps_server.snapshot()
        ps_server.mark_synced()
        for w in ps_workers.values():
            w.mark_durable()
        dtype = state.phi_acc.dtype
        # the replica is let go before the server's copy lands on the device
        state = dataclasses.replace(state, phi_acc=None)
        state = dataclasses.replace(
            state, phi_acc=torch.from_numpy(phi_srv).to(dev).to(dtype))

    warmup_s, warmup_launches = 0.0, {}

    def warm(step_fn, c) -> None:
        """The first launch of every kernel (the port's counterpart of the
        reference's compile) on a throwaway state with its own generator:
        the run's draws and result are untouched.  A dynamic run warms at
        its rung, the guard row kept.  Adds its launches to
        ``warmup_launches``."""
        before = launch_counts()
        words = c.vocab_size - 1 if dynamic else None
        live = (1,) if dynamic else ()
        pads, full = _warmup_batches(args, buckets, c, shards, words)
        scratch = fresh_state(c)
        for ids, cnt in pads:
            scratch, _ = step_fn(scratch, ids, cnt, *live)
        once, _ = build_step(
            dataclasses.replace(c, inner_iters=2, residual_tol=-1.0))
        scratch, _ = once(scratch, *full, *((words,) if dynamic else ()))
        del scratch
        sync_device()
        for k, n in launch_counts().items():
            warmup_launches[k] = warmup_launches.get(k, 0) + n - before[k]

    if args.warmup_buckets:
        t0 = time.time()
        warm(step, cfg)
        warmup_s = time.time() - t0
    eval_split = None
    consumed_m = start_m - 1     # the last consumed batch (slide's eval)
    slide = dynamic and args.drift_mode == "slide"

    def heldout():
        nonlocal eval_split
        if slide:
            # re-drawn from the current window at every evaluation
            return _eval_split_slide(args, max(consumed_m, 0))
        if eval_split is None:
            eval_split = (_eval_split_dynamic(args) if dynamic
                          else _eval_split(args))
        return eval_split

    def eval_ppl(phi=None) -> float:
        if phi is None:
            phi = global_phi(state.phi_acc)
        if not rank0:
            return float("nan")
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        if not dynamic:
            return perplexity.evaluate(phi, *heldout(), cfg, generator=gen,
                                       device=dev)
        # the split is in external key space: looked up at the current
        # vocabulary, unseen words to the first guard row
        tr, te = heldout()
        tr_b, te_b = (docs_to_padded(vocab.map_docs(d, admit=False,
                                                    oov_row=live_done))
                      for d in (tr, te))
        return perplexity.evaluate(phi, tr_b, te_b, cfg, generator=gen,
                                   device=dev, live_w=live_done)

    def extra_at(next_m: int) -> Dict[str, Any]:
        extra = {"next_m": next_m, "run": signature}
        if ps:
            # saves run with the pipeline drained and the state the
            # server's (ps_sync_state): phi_acc is the server statistic
            extra["ps"] = {**ps_server.manifest(),
                           "staleness": args.staleness}
        if dynamic:
            # the consumed prefix's vocabulary; touch stamps of rows the
            # prefetch re-touched ahead come back by max-merge on replay.
            # row_remap is the latest fence's remap, which lets an older
            # phi restore into this row space
            extra["dyn"] = {"w_cap": cfg.vocab_size, "live_w": live_done,
                            "vocab_keys": vocab.keys_upto(live_done),
                            "touched": vocab.touched_upto(live_done),
                            "vocab_version": vocab_version,
                            "row_remap": last_remap}
        return extra

    def save(step_no: int, next_m: int) -> None:
        phi = global_phi(state.phi_acc)
        if rank0:
            ckpt.save(args.ckpt_dir, step_no, _state_tree(LDATrainState(
                phi_acc=phi, m=state.m, generator=state.generator)),
                extra=extra_at(next_m))

    def new_rung(new_cap: int, fence_live: Optional[int] = None) -> None:
        """Resize the state to ``new_cap`` rows (a shrink under the fence
        of ``fence_live`` live rows), then rebuild and rewarm the step."""
        nonlocal state, cfg, step, meter
        state = lifecycle.resize_state(state, new_cap, live_w=fence_live)
        cfg = dataclasses.replace(cfg, vocab_size=new_cap)
        step, meter = build_step(cfg)
        if args.warmup_buckets:
            warm(step, cfg)

    growth_s = compact_s = 0.0
    growth_events, compaction_events, occupancy_trace = [], [], []
    fence_bytes = []

    def compaction_fence(fence_m: int) -> None:
        """The checkpoint-fenced compaction and topic recycling.  The
        segment's generator stopped before ``fence_m`` and every batch it
        yielded is consumed, so ``vocab.live == live_done`` and the touch
        stamps cover exactly the consumed prefix: the dead rows (and the
        remap) are a function of (stream, fence).  The new state, vocabulary
        and remap are saved at once."""
        nonlocal state, live_done, vocab_version, last_remap, compact_s
        sync_device()
        t_c = time.time()
        held = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                else None)
        live = vocab.live
        phi_host = state.phi_acc[:live].float().cpu().numpy()
        floor = float(args.compact_mass_tol) * cfg.num_topics * cfg.beta
        dead = lifecycle.dead_rows(
            phi_host.sum(axis=1), vocab.touched_upto(live), fence_m - 1,
            args.compact_min_idle, floor)
        del phi_host
        n_dead = int(dead.sum())
        live_new = live
        if n_dead:
            remap = vocab.compact(~dead)
            state = lifecycle.apply_row_remap(state, remap)
            live_new = vocab.live
            last_remap = [int(r) for r in remap]
            vocab_version += 1
        recycled = []
        if args.recycle_tol:
            phi2, recycled = lifecycle.recycle_topics(
                state.phi_acc.float().cpu().numpy(), live_new,
                args.recycle_tol)
            if recycled:
                state = LDATrainState(
                    phi_acc=torch.from_numpy(phi2).to(dev,
                                                      state.phi_acc.dtype),
                    m=state.m, generator=state.generator)
            del phi2
        # drop the rungs the compacted vocabulary no longer needs
        old_cap = cfg.vocab_size
        new_cap = next_capacity(live_new, 0, args.w_cap_min, args.w_growth)
        if new_cap < old_cap:
            new_rung(new_cap, fence_live=live_new)
        live_done = live_new
        if held is not None:
            fence_bytes.append({"m": fence_m, "w_cap": [old_cap, new_cap],
                                "allocated": [held, torch.cuda.
                                              memory_allocated(dev)]})
        if args.ckpt_dir:
            save(fence_m, fence_m)
        compact_s += time.time() - t_c
        if n_dead or recycled:
            compaction_events.append(
                {"m": fence_m, "dead": n_dead, "live_before": live,
                 "live_after": live_new, "w_cap": cfg.vocab_size,
                 "recycled": recycled})
            print(f"minibatch {fence_m:5d}  [compact] dead={n_dead} "
                  f"live_w={live} -> {live_new}  W_cap={cfg.vocab_size}"
                  + (f"  recycled_topics={recycled}" if recycled else ""),
                  flush=True)
        occupancy_trace.append({"m": fence_m, "live_w": live_done,
                                "w_cap": cfg.vocab_size})

    def make_stream(seg_start: int, seg_end: int):
        # one prefetched generator per fence segment: it stops before
        # seg_end, so nothing is admitted or touched past a fence
        if dynamic:
            return prefetched(drifting_stream(args, buckets, seg_start, vocab,
                                              end_m=seg_end), args.prefetch)
        return prefetched(synthetic_stream(args, buckets, seg_start),
                          args.prefetch)

    def elastic(m: int) -> list:
        """Apply batch ``m``'s membership events (DESIGN.md §17): joins and
        leaves repartition the round-robin stream before the batch is
        assigned; returns the workers that crash after its step."""
        victims = []
        for kind, name in elastic_events.get(m, ()):
            if kind == "join":
                if name not in ps_workers:
                    ps_workers[name] = make_worker(name)
                if name not in ps_active:
                    ps_active.append(name)
                elastic_log.append({"m": m, "event": "join", "worker": name})
            elif kind == "leave":
                if name not in ps_active:
                    raise ValueError(f"elastic leave of unknown worker "
                                     f"{name!r} at batch {m}")
                if len(ps_active) == 1:
                    raise ValueError(f"elastic leave of {name!r} at batch "
                                     f"{m} leaves no workers")
                ps_workers[name].flush()
                ps_retired.append(ps_workers.pop(name))
                ps_active.remove(name)
                elastic_log.append({"m": m, "event": "leave",
                                    "worker": name})
            else:
                victims.append(name)
        return victims

    def ps_step(m: int, batch, nxt):
        """Batch ``m`` as the assigned worker runs it: the touched rows
        (from the batch's host arrays) pulled into the replica, the step,
        a crashed worker's batch replayed by a survivor, the next batch's
        prefetch on its worker, this batch's delta pushed."""
        nonlocal state
        victims = elastic(m)
        cli = ps_workers[ps_active[m % len(ps_active)]]
        rows = touched_rows_of(batch.word_ids, batch.counts)
        # the replay's restore point: the step leaves phi_acc as it was
        # but advances the generator in place
        pre = (state, state.generator.get_state()) if victims else None
        state = dataclasses.replace(
            state, phi_acc=cli.begin_batch(m + 1, rows, state.phi_acc))
        sb = stack_shards(batch, shards)
        state, diag = step(state, sb.word_ids, sb.counts)
        for name in victims:
            if name not in ps_active:
                continue                   # already left or crashed
            if len(ps_active) == 1:
                raise ValueError(f"elastic crash of {name!r} at batch {m} "
                                 f"leaves no survivor")
            assigned = ps_active[m % len(ps_active)] == name
            ps_retired.append(ps_workers.pop(name))
            ps_active.remove(name)
            elastic_log.append({"m": m, "event": "crash", "worker": name,
                                "replayed": assigned})
            if assigned:
                # the victim died before its push: a survivor re-pulls the
                # same committed rows (the victim never pushed) and re-runs
                # the batch from the restore point with the same draws, so
                # the run equals an uncrashed one at S = 0
                cli = ps_workers[ps_active[m % len(ps_active)]]
                state, gen_state = pre
                state.generator.set_state(gen_state)
                state = dataclasses.replace(
                    state, phi_acc=cli.begin_batch(m + 1, rows,
                                                   state.phi_acc))
                state, diag = step(state, sb.word_ids, sb.counts)
        # the prefetch goes out before this push settles, on the worker
        # the next batch is assigned to (events at m + 1 may reroute it:
        # the mismatched pull is then drained)
        if nxt is not None:
            nb = nxt[0]
            ps_workers[ps_active[(m + 1) % len(ps_active)]].prefetch(
                m + 2, touched_rows_of(nb.word_ids, nb.counts))
        cli.end_batch(m + 1, state.phi_acc, rows)
        return diag

    buf = DiagBuffer(block=max(args.log_every, 64))
    ppl_trace = []
    tokens = 0.0
    t0 = time.time()
    seg_start = start_m
    try:
        while seg_start < args.minibatches:
            seg_end = (min(args.minibatches,
                           (seg_start // compact_every + 1) * compact_every)
                       if compact_every else args.minibatches)
            stream = make_stream(seg_start, seg_end)
            if ps:
                stream = _with_lookahead(stream)
            for m, item in enumerate(stream, start=seg_start):
                nxt = None
                if ps:
                    item, nxt = item
                if dynamic:
                    batch, ntok, live_b = item
                else:
                    (batch, ntok), live_b = item, None
                if dynamic and live_b >= cfg.vocab_size:
                    # a rung crossing: pad the state to the next rung
                    # (guard rows), rebuild and rewarm the step, and save
                    # the grown state, so a crash right here resumes on the
                    # new rung; the save holds live_done, the consumed
                    # prefix (this batch is not consumed yet)
                    sync_device()
                    t_g = time.time()
                    new_cap = next_capacity(live_b, cfg.vocab_size,
                                            args.w_cap_min, args.w_growth)
                    new_rung(new_cap)
                    if args.ckpt_dir:
                        save(m, m)
                    growth_s += time.time() - t_g
                    growth_events.append({"m": m, "w_cap": new_cap,
                                          "live_w": live_b})
                    print(f"minibatch {m + 1:5d}  [grow] live_w={live_b} "
                          f"-> W_cap={new_cap}", flush=True)
                if ps:
                    diag = ps_step(m, batch, nxt)
                else:
                    batch = stack_shards(batch, shards)
                    state, diag = step(state, batch.word_ids, batch.counts,
                                       *((live_b,) if dynamic else ()))
                buf.append(diag["mean_r"], diag["iters"])
                tokens += ntok
                if live_b is not None:
                    live_done = live_b
                consumed_m = m
                step_no = m + 1
                if args.log_every and step_no % args.log_every == 0:
                    dt = time.time() - t0
                    print(f"minibatch {step_no:5d}  "
                          f"mean_r={float(diag['mean_r']):.4f}"
                          f"  iters={int(diag['iters']):3d}"
                          f"  tokens/s={tokens / max(dt, 1e-9):,.0f}",
                          flush=True)
                if args.eval_every and step_no % args.eval_every == 0:
                    ppl = eval_ppl()
                    ppl_trace.append((step_no, ppl))
                    if rank0:
                        print(f"minibatch {step_no:5d}  held-out "
                              f"ppl={ppl:.2f}", flush=True)
                if args.crash_at and step_no == args.crash_at and \
                        start_m == 0:
                    # fresh runs only: a resumed run sails past the
                    # simulated failure, so rerunning the command completes
                    raise SystemExit(f"[simulated crash] after minibatch "
                                     f"{step_no}")
                if args.ckpt_dir and args.ckpt_every and \
                        step_no % args.ckpt_every == 0:
                    if ps:
                        ps_sync_state()
                    save(step_no, step_no)
            seg_start = seg_end
            if compact_every:
                compaction_fence(seg_end)
        sync_device()
        if ps:
            # drain and adopt the server's statistic (part of the run: a
            # fleet pays it once at shutdown)
            ps_sync_state()
    finally:
        if ps_transport is not None:
            # no transport thread outlives the run, a crash included
            ps_transport.close()
    wall = time.time() - t0

    rows = buf.rows()
    iters = [int(i) for _, i in rows]
    phi = global_phi(state.phi_acc)
    # steady tokens/s: growth events and fences (resize, rewarm, save) are
    # set-up-like costs, left out as the warm-up is; wall_s holds them
    steady_s = max(wall - growth_s - compact_s, 1e-9)
    result = {
        "first_m": start_m,
        "mean_r": [float(r) for r, _ in rows],
        "iters": iters,
        "len_buckets": list(buckets),
        "tokens": tokens,
        "wall_s": wall,
        "warmup_s": warmup_s,
        "warmup_launches": warmup_launches,
        "tokens_per_s": tokens / steady_s,
        "ppl": eval_ppl(phi),
        "ppl_trace": ppl_trace,
        "bytes_by_phase": dict(meter.bytes_by_phase),
        "per_minibatch_bytes": (meter.per_minibatch_bytes(iters[-1])
                                if iters else 0),
        "phi_acc": phi.cpu() if rank0 else None,
    }
    if ps:
        # worker-side stats over every client that ever ran (retired
        # workers did work too)
        every = list(ps_workers.values()) + ps_retired
        touched = [t for w in every for t in w.touched_history]
        mean_touched = float(np.mean(touched)) if touched else 0.0
        mt = max(int(round(mean_touched)), 1)
        wire = ps_transport.total_bytes
        result.update(
            staleness=args.staleness,
            ps_wire_bytes=int(wire),
            ps_wire_per_minibatch=wire / max(args.minibatches - start_m, 1),
            ps_pull_wait_s=sum(w.pull_wait_s for w in every),
            ps_push_wait_s=sum(w.push_wait_s for w in every),
            mean_touched_rows=mean_touched,
            ps_bytes_by_link=ps_transport.bytes_by_link(),
            ps_retries=sum(w.retries for w in every),
            ps_replayed_pushes=sum(w.replayed_pushes for w in every),
            ps_recoveries=sum(w.recoveries for w in every),
            ps_retry_wire_bytes=sum(w.retry_wire_bytes for w in every),
            ps_duplicates_dropped=ps_server.duplicates_dropped,
            ps_recovery_log=list(ps_server.recovery_log),
            chaos_events=ps_transport.event_counts() if chaos_on else {},
            elastic_log=elastic_log,
            ps_workers=sorted(ps_workers),
            # the meter's push/pull model billed at the measured mean
            # touched rows: the analytic check of the measured wire bytes
            bytes_by_phase_touched=dict(meter.bytes_by_phase_at(mt)),
            per_minibatch_bytes_touched=(
                meter.per_minibatch_bytes(iters[-1], live_w=mt)
                if iters else 0),
            # the replica's copies, batch by batch (PSClient.copies)
            ps_copies=[c for w in every for c in w.copies])
    if dynamic:
        result.update(
            w_cap=cfg.vocab_size,
            live_w=live_done,
            growth_s=growth_s,
            growth_events=growth_events,
            compact_s=compact_s,
            compaction_events=compaction_events,
            occupancy_trace=occupancy_trace,
            fence_bytes=fence_bytes,
            vocab_version=vocab_version,
            vocab_keys=vocab.keys_upto(live_done),
            bytes_by_phase_live=dict(meter.bytes_by_phase_at(live_done)),
            per_minibatch_bytes_live=(
                meter.per_minibatch_bytes(iters[-1], live_w=live_done)
                if iters else 0))
    return result


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
    if "ranks" in res:
        same = all(r["iters"] == res["iters"] and r["mean_r"] == res["mean_r"]
                   for r in res["ranks"])
        print(f"[mesh] {len(res['ranks'])} ranks over "
              f"{res['dist_backend']}: iters and mean_r equal on every rank: "
              f"{same}")
    if args.backend == "ps":
        print(f"[ps] staleness={res['staleness']}  wire/minibatch="
              f"{res['ps_wire_per_minibatch']:,.0f}B  mean_touched_rows="
              f"{res['mean_touched_rows']:.0f}  pull_wait="
              f"{res['ps_pull_wait_s']:.2f}s  push_wait="
              f"{res['ps_push_wait_s']:.2f}s")
        if res.get("chaos_events") or res.get("ps_retries"):
            print(f"[chaos] events={res['chaos_events']}  "
                  f"retries={res['ps_retries']}  "
                  f"replayed={res['ps_replayed_pushes']}  "
                  f"recoveries={res['ps_recoveries']}  "
                  f"dup_dropped={res['ps_duplicates_dropped']}")
        if res.get("elastic_log"):
            print(f"[elastic] workers={res['ps_workers']}  "
                  f"events={res['elastic_log']}")
    if args.dynamic_vocab:
        print(f"[vocab] live_w={res['live_w']}  W_cap={res['w_cap']}  "
              f"growths={len(res['growth_events'])} "
              f"({res['growth_s']:.1f}s)  per-minibatch bytes at live W="
              f"{res['per_minibatch_bytes_live']:,}")
        if args.compact_every:
            print(f"[lifecycle] compactions={len(res['compaction_events'])} "
                  f"({res['compact_s']:.1f}s)  vocab_version="
                  f"{res['vocab_version']}  occupancy="
                  f"{res['live_w']}/{res['w_cap']}")
    return res


if __name__ == "__main__":
    main()
