"""LM training driver of the port (counterpart of ``repro.launch.train``):
LM training with data-parallel gradient sync by PowerSync (the paper's
technique generalized) or a dense all-reduce, and checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 200 --batch 16 --seq 64 --shards 4 --sync power \\
      --ckpt-dir /tmp/ckpt --device cuda

It takes the reference's flags with their defaults, prints its lines, and
``main(argv)`` returns ``(losses, meter)`` as the reference's does.
``--device`` (default ``cuda``) picks the card or, when asked, the CPU.
``--shards N > 1`` runs N data shards in lockstep on one device
(``core.sync.SimReducer`` through ``lockstep``, a thread a shard: the
reference's ``vmap(axis_name="dp")``); each shard takes the loss and grads
of ``loss_fn`` on its ``[batch / N, seq]`` slice and syncs them through
``optim.powersync.powersync_tree`` (error feedback in a residual of its
own) or ``dense_sync_tree``; AdamW then steps once, since the shards'
synced grads, and so their params and optimizer state, are equal.  One
step is one ``CommMeter.section()``, so ``meter.bytes_by_phase`` holds one
step's bytes, as the reference's trace-time meter does.

Fault tolerance: ``--crash-at N`` exits by ``SystemExit`` after step N;
rerunning the same command restores the newest checkpoint (params, AdamW
state, PowerSync residuals and the data cursor; the stream is a pure
function of (seed, step)) and continues the same trajectory.  The
checkpoint's keys are the reference's, so either package resumes the
other's.  Params are drawn from ``--seed`` by the port's ``init`` (other
draws than the reference's); `train_loop` takes injected params.  The
VLM and enc-dec ids are refused: the reference trainer's batch carries no
``image_embeds`` or ``frames``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.sync import CommMeter, LocalReducer, SimReducer, lockstep
from repro_torch.data.lm_data import batch_at
from repro_torch.dist import checkpoint as ckpt
from repro_torch.models import registry
from repro_torch.models.common import (tree_at, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.powersync import (PowerSyncConfig, dense_sync_tree,
                                         powersync_tree, residual_init)


def build_trainer(cfg, acfg: AdamWConfig, pscfg: PowerSyncConfig,
                  shards: int, sync: str, device="cuda"):
    """Returns (step, meter, mod): ``step(params, opt, residual, batch)``
    -> (loss [shards] or 0-d, new params, new AdamW state, residual).
    With ``shards`` > 1 the batch and the residual carry a leading shard
    axis and the residual is updated in place.  While a profiler records,
    a step is recorded in ``obs`` (root ``lm.step``; ``lm.loss``, forward
    and backward enqueued, ``lm.sync``, ``lm.adamw``; the model's regions
    inside ``lm.loss``; counter ``tokens``, and the MoE layers'
    ``moe_rows``, ``moe_rows_max`` and ``dropped``)."""
    dev = resolve_device(device)
    mod = registry.build(cfg)
    meter = CommMeter()
    n = max(shards, 1)
    reducer = (SimReducer(shards, meter=meter) if shards > 1
               else LocalReducer(meter=meter))

    def shard_body(params, residual, batch):
        rec = obs.active()
        leaves = [leaf.detach().requires_grad_()
                  for _, leaf in tree_leaves(params)]
        with meter.section():
            with obs.span(rec, "lm.loss"), torch.enable_grad():
                loss = mod.loss_fn(tree_unflatten(params, leaves), batch, cfg)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = tree_unflatten(params, [
                torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, grads)])
            with obs.span(rec, "lm.sync"):
                if sync == "power":
                    synced, residual = powersync_tree(grads, residual,
                                                      reducer, pscfg, n)
                else:
                    synced = dense_sync_tree(grads, reducer, n)
        return loss.detach(), synced, residual

    def step(params, opt, residual, batch):
        with obs.step("lm.step") as rec:
            if rec is not None:
                rec.count(tokens=batch["tokens"].numel())
            loss, synced, residual = sync_grads(params, residual, batch, rec)
            with obs.span(rec, "lm.adamw"):
                new_params, new_opt = adamw_update(synced, opt, acfg)
        return loss, new_params, new_opt, residual

    def sync_grads(params, residual, batch, rec):
        if shards > 1:
            def body(s):
                with obs.shard(rec, s):
                    return shard_body(params, tree_at(residual, s),
                                      {k: v[s] for k, v in batch.items()})
            outs = lockstep(body, shards, [reducer], device=dev)
            loss = torch.stack([o[0] for o in outs])
            synced = outs[0][1]
            if sync == "power":
                for s, (_, _, res) in enumerate(outs):
                    tree_map(lambda dst, src: dst.copy_(src),
                             tree_at(residual, s), res)
            del outs
            return loss, synced, residual
        return shard_body(params, residual, batch)

    return step, meter, mod


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--sync", default="power", choices=["power", "dense"])
    ap.add_argument("--lambda-rows", type=float, default=0.2)
    ap.add_argument("--lambda-cols", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; pass "
                         "cpu to run on the host)")
    return ap


def train_loop(args, params: Optional[Any] = None, step_walls=None,
               trace_step=None):
    """The trainer over parsed ``args``; returns (losses, meter).

    ``params`` injects the initial params (a tree on ``args.device``, for
    example the reference's through ``convert.lm_params_from_reference``)
    in place of ``init``'s draw from ``--seed``.  ``step_walls``, a list,
    receives each step's host seconds, ended by the read of its loss (a
    device sync).  ``trace_step``, ``(step, wrapper)``, runs that step as
    ``wrapper(thunk)`` (a profiler around it)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "audio"):
        what = "image_embeds" if cfg.family == "vlm" else "frames"
        raise ValueError(
            f"--arch {args.arch}: the trainer's batch (data.lm_data."
            f"batch_at, as the reference trainer's) carries no {what}, which "
            f"the {cfg.family} family needs")
    dev = resolve_device(args.device)
    acfg = AdamWConfig(lr=args.lr, warmup_steps=20)
    pscfg = PowerSyncConfig(lambda_rows=args.lambda_rows,
                            lambda_cols=args.lambda_cols)
    step_fn, meter, mod = build_trainer(cfg, acfg, pscfg, args.shards,
                                        args.sync, dev)

    if params is None:
        params = mod.init(cfg, seed=args.seed, device=dev)
    opt = adamw_init(params)
    residual = residual_init(params)
    if args.shards > 1:
        residual = tree_map(lambda r: r.new_zeros((args.shards, *r.shape)),
                            residual)
    start = 0

    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            # a checkpoint is written after a step, when every param leaf
            # is bf16 (AdamW casts the master for every leaf)
            template = {"params": tree_map(lambda p: p.to(torch.bfloat16),
                                           params),
                        "opt": opt, "residual": residual}
            trees, extra, _ = ckpt.restore(args.ckpt_dir, latest, template)
            params, opt, residual = (trees["params"], trees["opt"],
                                     trees["residual"])
            start = extra["next_step"]
            print(f"[restore] resumed from step {latest} -> next {start}")

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = batch_at(args.seed, step, args.batch, args.seq,
                         cfg.vocab_size,
                         shards=args.shards if args.shards > 1 else 0,
                         device=dev)
        ts = time.time()

        def run():
            return step_fn(params, opt, residual, batch)

        if trace_step is not None and trace_step[0] == step:
            loss, params, opt, residual = trace_step[1](run)
        else:
            loss, params, opt, residual = run()
        losses.append(float(np.mean(loss.cpu().numpy())))
        if step_walls is not None:
            step_walls.append(time.time() - ts)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.crash_at and step + 1 == args.crash_at:
            raise SystemExit(f"[simulated crash] at step {step + 1}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1,
                      {"params": params, "opt": opt, "residual": residual},
                      extra={"next_step": step + 1, "seed": args.seed,
                             "sync": args.sync})
    print(f"[done] final loss {losses[-1]:.4f}; "
          f"comm bytes/step by phase: {meter.bytes_by_phase}")
    return losses, meter


def main(argv=None):
    return train_loop(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
