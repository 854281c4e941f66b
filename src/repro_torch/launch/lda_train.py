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

Every other flag of the reference driver is accepted only at its
reference default, and any other value raises naming the ROADMAP item
that ports it; so does ``--backend ps``.
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
    ap.add_argument("--shards", type=int, default=4,
                    help="data shards in lockstep on one device "
                         "(--backend sim)")
    ap.add_argument("--backend", default="sim",
                    choices=["sim", "shard_map", "ps"],
                    help="sim: --shards in lockstep on one device; "
                         "shard_map: a process a mesh position; ps: not "
                         f"ported yet ({_Q1} 7 (parameter server))")
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
    if args.backend == "ps":
        raise NotImplementedError(
            f"--backend ps is not ported yet ({_Q1} 7 (parameter server))")
    for name, (default, item) in _UNPORTED.items():
        value = getattr(args, name)
        if value != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')}={value!r} is not ported yet "
                f"({item}); this driver runs a fixed vocabulary")


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


def _warmup_batches(args, buckets, cfg, shards: int = 1):
    """What the warm-up pushes through the step: an all-padding [D, L]
    batch of each length bucket (they stop at t = 1), and one batch of the
    smallest bucket with every slot counted, for a step that runs one
    selective iteration (the policy's selective kernels); stacked [N, D/N,
    L] for ``shards`` data shards."""
    import torch

    D = args.docs_per_batch
    pads = [(torch.zeros((D, L), dtype=torch.int32),
             torch.zeros((D, L), dtype=torch.float32))
            for L in (buckets[-1:] if args.fixed_len else buckets)]
    L = pads[0][0].shape[1]
    ids = (torch.arange(D * L, dtype=torch.int32) % cfg.vocab_size
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


def train_loop(args) -> Dict[str, Any]:
    """Run the driver; returns a result dict (see the end).  With
    ``--backend shard_map`` and no process group yet, starts the mesh
    (`_run_mesh`); inside one, runs this rank."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core import perplexity
    from repro_torch.core.device import resolve_device
    from repro_torch.core.pobp import (DiagBuffer, init_train_state,
                                       make_train_step, mesh_data_index)
    from repro_torch.core.types import LDATrainState
    from repro_torch.data.batching import prefetched, stack_shards
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.kernels import launch_counts

    _reject_unported(args)
    if args.backend == "shard_map" and not dist.is_initialized():
        return _run_mesh(args)
    if args.crash_at and not args.ckpt_dir:
        raise ValueError("--crash-at needs --ckpt-dir: without a checkpoint "
                         "the rerun restarts from scratch and hits the same "
                         "simulated failure forever")
    cfg, buckets = _build_cfg(args)
    dev = resolve_device(args.device)
    shards = args.shards if args.backend == "sim" else 1
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
        if mesh is None:
            return make_train_step(c, shards, args.sync, args.sync_dtype,
                                   device=dev)
        return make_shardmap_train_step(c, mesh, args.sync, args.sync_dtype)

    def fresh_state():
        st = init_train_state(cfg, args.seed, device=dev)
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

    step, meter = build_step(cfg)
    state = fresh_state()
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

    warmup_s, warmup_launches = 0.0, {}
    if args.warmup_buckets:
        # the first launch of every kernel (the port's counterpart of the
        # reference's compile) on a throwaway state with its own generator:
        # the run's draws and result are untouched
        t0 = time.time()
        before = launch_counts()
        pads, full = _warmup_batches(args, buckets, cfg, shards)
        scratch = fresh_state()
        for ids, cnt in pads:
            scratch, _ = step(scratch, ids, cnt)
        once, _ = build_step(
            dataclasses.replace(cfg, inner_iters=2, residual_tol=-1.0))
        scratch, _ = once(scratch, *full)
        del scratch
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warmup_s = time.time() - t0
        warmup_launches = {k: n - before[k]
                           for k, n in launch_counts().items()}
    eval_split = None

    def eval_ppl(phi=None) -> float:
        nonlocal eval_split
        if phi is None:
            phi = global_phi(state.phi_acc)
        if not rank0:
            return float("nan")
        if eval_split is None:
            eval_split = _eval_split(args)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        return perplexity.evaluate(phi, *eval_split, cfg, generator=gen,
                                   device=dev)

    buf = DiagBuffer(block=max(args.log_every, 64))
    ppl_trace = []
    tokens = 0.0
    t0 = time.time()
    stream = prefetched(synthetic_stream(args, buckets, start_m),
                        args.prefetch)
    for m, (batch, ntok) in enumerate(stream, start=start_m):
        batch = stack_shards(batch, shards)
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
            if rank0:
                print(f"minibatch {step_no:5d}  held-out ppl={ppl:.2f}",
                      flush=True)
        if args.crash_at and step_no == args.crash_at and start_m == 0:
            # fresh runs only: a resumed run sails past the simulated
            # failure, so rerunning the same command completes
            raise SystemExit(f"[simulated crash] after minibatch {step_no}")
        if args.ckpt_dir and args.ckpt_every and \
                step_no % args.ckpt_every == 0:
            phi = global_phi(state.phi_acc)
            if rank0:
                ckpt.save(args.ckpt_dir, step_no, _state_tree(LDATrainState(
                    phi_acc=phi, m=state.m, generator=state.generator)),
                    extra={"next_m": step_no, "run": signature})
            del phi
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    rows = buf.rows()
    iters = [int(i) for _, i in rows]
    phi = global_phi(state.phi_acc)
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
        "ppl": eval_ppl(phi),
        "ppl_trace": ppl_trace,
        "bytes_by_phase": dict(meter.bytes_by_phase),
        "per_minibatch_bytes": (meter.per_minibatch_bytes(iters[-1])
                                if iters else 0),
        "phi_acc": phi.cpu() if rank0 else None,
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
    if "ranks" in res:
        same = all(r["iters"] == res["iters"] and r["mean_r"] == res["mean_r"]
                   for r in res["ranks"])
        print(f"[mesh] {len(res['ranks'])} ranks over "
              f"{res['dist_backend']}: iters and mean_r equal on every rank: "
              f"{same}")
    return res


if __name__ == "__main__":
    main()
