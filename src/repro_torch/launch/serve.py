"""Serving driver of the port (counterpart of ``repro.launch.serve``).

LDA mode: load a trained phi from a checkpoint (the JAX package's format)
and serve topic mixtures for a synthetic request stream.
``--admission slab`` (the default) runs the continuous-batching
`SlabEngine`; ``--admission bucket`` the `FoldInEngine` ladder.  With
``--qps`` requests arrive open-loop on an exponential clock;
``--swap-at`` hot-swaps phi mid-stream; ``--slo-ms`` checks p99;
``--report-json`` writes the report.  ``--device`` (default ``cuda``)
picks the card or, when asked, the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lda \\
      --ckpt-dir /tmp/lda_ck --requests 256 --device cuda

LM mode: greedy decode of ``--batch`` streams with KV caches for any
``--arch`` id (``--reduced`` for its small variant): the prompt goes in
through decode steps, then ``--gen`` greedy tokens come out.  Params and
prompts are random from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
      --arch smollm-360m --reduced --gen 16 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_open_loop(engine, reqs, qps: float, *, seed: int = 0,
                  swap_at=None, swap_fn=None, max_age_s: float = 0.05,
                  tenants=None):
    """Submit ``reqs`` on an exponential arrival clock at ``qps`` docs/s,
    servicing the engine between arrivals (slab: ``step``; bucket:
    ``flush_stale`` + ``poll``); ``swap_fn(engine)`` fires once when the
    ``swap_at`` stream fraction is crossed.  Returns (results, wall_s)."""
    from repro_torch.serve import SlabEngine

    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=len(reqs))
    is_slab = isinstance(engine, SlabEngine)
    swap_idx = (int(swap_at * len(reqs)) if swap_at is not None else None)
    results = []
    t0 = time.time()
    arrive = t0 + np.cumsum(gaps)
    for i, doc in enumerate(reqs):
        if swap_idx is not None and i == swap_idx and swap_fn is not None:
            swap_fn(engine)
        while True:
            now = time.time()
            if now >= arrive[i]:
                break
            if is_slab:
                if engine.in_flight():
                    engine.step()
                    results.extend(engine.poll())
                else:
                    time.sleep(min(1e-3, arrive[i] - now))
            else:
                n = engine.flush_stale(max_age_s)
                got = engine.poll()
                results.extend(got)
                if not n and not got:
                    time.sleep(min(1e-3, arrive[i] - now))
        if tenants is not None and is_slab:
            engine.submit(doc, tenant=tenants[i])
        else:
            engine.submit(doc)
    results.extend(engine.drain())
    return results, time.time() - t0


def _request_stream(cfg, args):
    """Synthetic mixed-length ingress drawn on the host from the LDA
    generative model at the served geometry."""
    from repro_torch.data.synthetic import lda_corpus

    means = [int(x) for x in args.doc_len_means.split(",")]
    reqs = []
    for i, mean in enumerate(means):
        d, _, _ = lda_corpus(args.seed + 100 + i,
                             -(-args.requests // len(means)),
                             cfg.vocab_size, cfg.num_topics,
                             doc_len_mean=mean)
        reqs.extend(d)
    return reqs[:args.requests]


def serve_lda(args):
    import torch

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.serve import FoldInEngine, OOVTrigger, SlabEngine

    if args.admission == "slab":
        engine = SlabEngine.from_checkpoint(
            args.ckpt_dir, slots=args.slots, slot_len=args.slot_len,
            sweeps_per_step=args.sweeps_per_step,
            fold_iters=args.fold_iters, residual_tol=args.tol,
            topic_shards=args.topic_shards, seed=args.seed,
            theta_cache=args.theta_cache or None,
            cache_mode=args.cache_mode,
            oov_trigger=(OOVTrigger(args.oov_retrain_rate)
                         if args.oov_retrain_rate > 0 else None),
            admission_slo_s=(args.admission_slo_ms / 1e3
                             if args.admission_slo_ms else None),
            device=args.device)
        geom = (f"slab {engine.slots}x{engine.slot_len} "
                f"({engine.sweeps_per_step} sweeps/step)")
    else:
        engine = FoldInEngine.from_checkpoint(
            args.ckpt_dir,
            len_buckets=tuple(int(b) for b in args.len_buckets.split(",")),
            batch_docs=args.batch, fold_iters=args.fold_iters,
            residual_tol=args.tol, topic_shards=args.topic_shards,
            seed=args.seed, device=args.device)
        geom = f"buckets {engine.len_buckets}"
    cfg = engine.cfg
    print(f"[load] phi[{cfg.vocab_size}, {cfg.num_topics}] from "
          f"{args.ckpt_dir} on {engine.device}  (live vocab "
          f"{engine.live_words}, warmup {engine.warmup_s:.2f}s, {geom})")

    reqs = _request_stream(cfg, args)
    swap_fn = None
    if args.swap_at is not None:
        # re-serve the same checkpointed statistic as a new generation:
        # exercises the fence, version stamps and cache invalidation
        phi_next, _, _ = ckpt.restore_phi(args.ckpt_dir, dtype=torch.float32)

        def swap_fn(e, _phi=phi_next):
            t0 = time.time()
            e.swap_phi(_phi)
            print(f"[swap] phi generation {e.phi_version} installed "
                  f"({time.time() - t0:.2f}s fence+install)")

    t_wall0 = time.time()
    if args.qps > 0:
        results, wall = run_open_loop(
            engine, reqs, args.qps, seed=args.seed, swap_at=args.swap_at,
            swap_fn=swap_fn, max_age_s=args.max_age_ms / 1e3)
    else:
        if swap_fn is not None:
            half = int(args.swap_at * len(reqs))
            for doc in reqs[:half]:
                engine.submit(doc)
            swap_fn(engine)
            for doc in reqs[half:]:
                engine.submit(doc)
        else:
            for doc in reqs:
                engine.submit(doc)
        results = engine.drain()
        wall = time.time() - t_wall0

    s = engine.stats()
    goodput = len(results) / wall if wall > 0 else float("nan")
    batches = (f" in {s['dispatches']} batches" if "dispatches" in s
               else f" over {s['steps']} slab steps")
    print(f"[serve] {s['served']} docs{batches} on {engine.device}: "
          f"{goodput:,.0f} docs/s  "
          f"p50={s['latency_p50_s'] * 1e3:.1f}ms  "
          f"p99={s['latency_p99_s'] * 1e3:.1f}ms  "
          f"mean fold iters={s['mean_fold_iters']:.1f}  "
          f"oov rate={s['oov_rate']:.3f}  "
          f"occupancy={s['live_words']}/{s['w_cap']} "
          f"({s['occupancy']:.2f})")
    if args.admission == "slab":
        print(f"[slab] occupancy={s['slot_occupancy']:.2f}  "
              f"cache_served={s['cache_served']}  "
              f"warm_starts={s['warm_starts']}  "
              f"retrain_batches={s['retrain_batches']}")
        if s["shed"] or s["quarantined"]:
            print(f"[shed] {s['shed']} requests shed "
                  f"({s['shed_frac']:.2%} of offered load, SLO "
                  f"{s['admission_slo_s']}s)  "
                  f"quarantined={s['quarantined']}")
    slo_ok = None
    if args.slo_ms is not None:
        slo_ok = bool(s["latency_p99_s"] * 1e3 <= args.slo_ms)
        print(f"[slo] p99 {s['latency_p99_s'] * 1e3:.1f}ms vs "
              f"{args.slo_ms:.0f}ms objective: "
              f"{'MET' if slo_ok else 'BREACHED'}")
    top = np.asarray(results[0].theta).argsort()[-3:][::-1]
    print(f"[sample] req 0: top topics {top.tolist()} "
          f"(theta {np.asarray(results[0].theta)[top].round(3).tolist()})")
    if args.report_json:
        report = {"admission": args.admission, "requests": len(reqs),
                  "device": str(engine.device),
                  "qps_target": args.qps, "wall_s": wall,
                  "goodput_docs_per_s": goodput, "slo_ms": args.slo_ms,
                  "slo_met": slo_ok, "swap_at": args.swap_at,
                  "stats": s}
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, default=float)
        print(f"[report] wrote {args.report_json}")
    return results, s


def serve_lm(args, *, trace_step=None):
    """Greedy decode of ``args.batch`` streams: ``prompt_len + gen - 1``
    decode steps into caches of ``prompt_len + gen`` positions, the prompt
    fed through decode steps, then argmax tokens.  Each step ends in a
    device sync, so its wall time is the step's.  With ``trace_step``, one
    more decode step (the last cache position) runs as
    ``trace_step(fn)`` after the timed loop.  Returns the new tokens
    [B, gen] (on the host), each step's seconds, the wall seconds, tokens
    per second and whether every step's logits were finite."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models import registry

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mod = registry.build(cfg)
    params = mod.init(cfg, seed=args.seed, device=dev)
    B, S = args.batch, args.prompt_len
    total = S + args.gen
    prompt = torch.randint(
        0, cfg.vocab_size, (B, S), dtype=torch.int32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    caches = registry.cache_zeros(cfg, B, total, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    finite = torch.ones((), dtype=torch.bool, device=dev)
    tok, out_toks, step_s = prompt[:, :1], [], []
    sync()
    t0 = time.time()
    for i in range(total - 1):
        ts = time.time()
        logits, caches = mod.decode_step(params, tok, caches, i, cfg)
        finite &= torch.isfinite(logits).all()
        if i + 1 < S:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out_toks.append(tok[:, 0])
        sync()
        step_s.append(time.time() - ts)
    dt = time.time() - t0
    tokens = (torch.stack(out_toks, 1).cpu() if out_toks
              else torch.zeros((B, 0), dtype=torch.int32))
    print(f"[serve-lm] {B} streams x {args.gen} new tokens in {dt:.2f}s "
          f"({B * args.gen / max(dt, 1e-9):.1f} tok/s); "
          f"sample: {tokens[0, :8].tolist()}")
    if trace_step is not None:
        trace_step(lambda: mod.decode_step(params, tok, caches, total - 1,
                                           cfg))
    return {"tokens": tokens, "step_s": step_s, "wall_s": dt,
            "tok_per_s": B * args.gen / max(dt, 1e-9),
            "finite": bool(finite), "vocab_size": cfg.vocab_size}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lda", choices=["lda", "lm"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; pass "
                         "cpu to run the plain versions on the host)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint to serve from (required for --mode lda)")
    ap.add_argument("--admission", default="slab",
                    choices=["slab", "bucket"],
                    help="continuous-batching slab (default) or the "
                         "bucket-ladder baseline")
    ap.add_argument("--slots", type=int, default=64,
                    help="slab: in-flight document slots")
    ap.add_argument("--slot-len", type=int, default=64,
                    help="slab: tokens per slot (longer docs truncate "
                         "by top count mass)")
    ap.add_argument("--sweeps-per-step", type=int, default=4,
                    help="slab: fold-in sweeps per step")
    ap.add_argument("--theta-cache", type=int, default=0,
                    help="slab: theta LRU capacity (0 = off)")
    ap.add_argument("--cache-mode", default="serve",
                    choices=["serve", "warm"],
                    help="slab: cache hits skip fold-in (serve) or "
                         "warm-start it (warm)")
    ap.add_argument("--oov-retrain-rate", type=float, default=0.0,
                    help="slab: OOV token rate that triggers a hot-OOV "
                         "retraining batch (0 = off)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop arrival rate in docs/s "
                         "(0 = closed-loop: submit all, then drain)")
    ap.add_argument("--swap-at", type=float, default=None,
                    help="hot-swap phi after this fraction of the "
                         "request stream")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="p99 latency objective to check the run against")
    ap.add_argument("--admission-slo-ms", type=float, default=None,
                    help="slab: shed a request at submit when its "
                         "estimated wait exceeds this deadline")
    ap.add_argument("--max-age-ms", type=float, default=50.0,
                    help="bucket: flush a bucket once its oldest request "
                         "waited this long (open-loop only)")
    ap.add_argument("--report-json", default=None,
                    help="write the latency/goodput/oov report to this "
                         "path as JSON")
    ap.add_argument("--len-buckets", default="16,32,64",
                    help="bucket admission L ladder (multiples of 8)")
    ap.add_argument("--fold-iters", type=int, default=30)
    ap.add_argument("--tol", type=float, default=1e-2,
                    help="per-document early-exit residual tolerance")
    ap.add_argument("--topic-shards", type=int, default=1)
    ap.add_argument("--doc-len-means", default="12,24,40")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    # shared / lm
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="lda: docs per fold-in batch of the bucket engine "
                         "(default 32); lm: decode streams (default 8)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 32 if args.mode == "lda" else 8
    if args.mode == "lda" and not args.ckpt_dir:
        ap.error("--mode lda needs --ckpt-dir")
    return args


def main(argv=None):
    args = parse_args(argv)
    return serve_lm(args) if args.mode == "lm" else serve_lda(args)


if __name__ == "__main__":
    main()
