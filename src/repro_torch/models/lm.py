"""Decoder-only LM assembly for all decoder families (counterpart of
``repro.models.lm``):

  dense   — [attn + mlp] x N
  moe     — dense_first_n plain layers, then [attn + moe] x rest
  vlm     — groups of (cross_attn_every-1 self layers + 1 cross layer);
            vision frontend is a stub (precomputed patch embeddings input)
  ssm     — [mamba2] x N
  hybrid  — groups of (shared_attn_every mamba2 layers) + one SHARED
            attention block (weights reused across groups, Zamba2-style,
            fed concat(hidden, initial embedding))

Params and caches are stacked over [n_layers, ...] as in the reference; a
Python loop walks the leading axis where the reference scans it.  A decode
step writes its caches in place and returns them.  ``mode="train"`` wraps
each body the reference wraps in ``jax.checkpoint`` (each stacked layer of
dense/moe, each group of vlm and hybrid, each ssm layer) in activation
checkpointing by ``cfg.remat_policy`` (`_remat`), and keeps no caches: it
returns an empty cache dict.  ``mode="prefill"`` returns the caches that
decoding continues from.  ``loss_fn`` is the training loss.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (NULL_CTX, Draw, ShardingCtx,
                                       dense_init, embed_init, layernorm,
                                       rmsnorm, softmax_xent, stack_init,
                                       tree_at, tree_leaves, tree_stack,
                                       tree_unflatten)


# ------------------------------------------------------------------ remat

# JAX's ``dots_with_no_batch_dims_saveable``: the outputs of matmuls with
# no batch dims (the projections) are saved, everything else is
# recomputed, attention's batched products included
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ArchConfig):
    """``fn`` under activation checkpointing with the configured policy
    (the reference's ``jax.checkpoint``): ``"dots"`` saves the projections'
    outputs and recomputes the rest in the backward pass, ``"full"``
    saves nothing but the inputs."""
    if cfg.remat_policy == "dots":
        def ctx():
            return create_selective_checkpoint_contexts(_save_dots)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=ctx)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _layers(stacked):
    """The per-layer trees of a stacked tree: views along the leading axis
    by ``unbind``, whose backward stacks the layers' grads in one op
    (indexing each layer would give each layer's grad a full-size
    [n_layers, ...] buffer of its own)."""
    leaves = [leaf.unbind(0) for _, leaf in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [u[i] for u in leaves])
            for i in range(_n_layers(stacked))]


# ---------------------------------------------------------------- blocks

def _norm(params, x, cfg):
    if cfg.norm == "rms":
        return rmsnorm(x, params["w"], cfg.norm_eps)
    return layernorm(x, params["w"], params["b"], cfg.norm_eps)


def _norm_params(draw: Draw, cfg):
    p = {"w": draw.full((cfg.d_model,), 1.0)}
    if cfg.norm != "rms":
        p["b"] = draw.full((cfg.d_model,), 0.0)
    return p


def self_block_params(draw: Draw, cfg: ArchConfig, use_moe: bool):
    p = {"ln1": _norm_params(draw, cfg), "ln2": _norm_params(draw, cfg)}
    if cfg.attn_type == "mla":
        p["attn"] = attn.mla_params(draw, cfg)
    else:
        p["attn"] = attn.gqa_params(draw, cfg)
    if use_moe:
        p["moe"] = moe_mod.moe_params(draw, cfg)
    else:
        p["mlp"] = mlp_mod.mlp_params(draw, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def self_block_apply(p, x, *, cfg: ArchConfig, positions, cache=None,
                     pos=None, window: int = 0, ctx: ShardingCtx = NULL_CTX):
    """Pre-norm attn + FFN.  Returns (x, cache, aux)."""
    h = _norm(p["ln1"], x, cfg)
    apply = attn.mla_apply if cfg.attn_type == "mla" else attn.gqa_apply
    a, new_cache = apply(p["attn"], h, cfg=cfg, positions=positions,
                         cache=cache, pos=pos, window=window, ctx=ctx)
    x = x + a
    h = _norm(p["ln2"], x, cfg)
    if "moe" in p:
        f, aux = moe_mod.moe_apply(p["moe"], h, cfg=cfg, ctx=ctx)
    else:
        f, aux = mlp_mod.mlp_apply(p["mlp"], h, act=cfg.act, ctx=ctx), 0.0
    return x + f, new_cache, aux


def cross_block_params(draw: Draw, cfg: ArchConfig):
    return {"ln1": _norm_params(draw, cfg), "ln2": _norm_params(draw, cfg),
            "xattn": attn.cross_params(draw, cfg),
            "mlp": mlp_mod.mlp_params(draw, cfg.d_model, cfg.d_ff, cfg.act),
            "gate": draw.full((1,), 0.0)}


def cross_block_apply(p, x, memory, *, cfg, mem_kv=None,
                      ctx: ShardingCtx = NULL_CTX):
    h = _norm(p["ln1"], x, cfg)
    a, mem_kv = attn.cross_apply(p["xattn"], h, memory, cfg=cfg,
                                 mem_kv=mem_kv, ctx=ctx)
    x = x + torch.tanh(p["gate"]) * a
    h = _norm(p["ln2"], x, cfg)
    return x + mlp_mod.mlp_apply(p["mlp"], h, act=cfg.act, ctx=ctx), mem_kv


def ssm_block_params(draw: Draw, cfg: ArchConfig):
    return {"ln": _norm_params(draw, cfg),
            "ssm": ssm_mod.ssm_params(draw, cfg)}


def shared_attn_params(draw: Draw, cfg: ArchConfig):
    """Zamba2 shared block: concat(hidden, embed0) [2D] -> D, attn + mlp."""
    return {"in_proj": dense_init(draw, 2 * cfg.d_model, cfg.d_model),
            "block": self_block_params(draw, cfg, use_moe=False)}


# ---------------------------------------------------------------- init

def _n_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(group_size, n_groups) of the stacked layers for this family."""
    if cfg.family == "vlm":
        return cfg.cross_attn_every, cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "hybrid":
        return cfg.shared_attn_every, cfg.n_layers // cfg.shared_attn_every
    return 1, cfg.n_layers - cfg.dense_first_n


def init(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random params from ``seed``, drawn leaf by leaf on ``device`` in
    their final dtypes (``device="meta"``: shapes and dtypes only).  The
    tree has the reference's keys and shapes; the draws are torch's."""
    draw = Draw(resolve_device(device), seed)
    params: Dict[str, Any] = {"embed": embed_init(draw, cfg.padded_vocab,
                                                  cfg.d_model),
                              "ln_f": _norm_params(draw, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(draw, cfg.d_model, cfg.padded_vocab)

    gsize, ngroups = _n_groups(cfg)
    if cfg.family in ("dense", "moe"):
        if cfg.dense_first_n:
            params["head_blocks"] = [
                self_block_params(draw, cfg, use_moe=False)
                for _ in range(cfg.dense_first_n)]
        params["stack"] = stack_init(
            draw, ngroups,
            lambda: self_block_params(draw, cfg, use_moe=cfg.moe is not None))
    elif cfg.family == "vlm":
        params["stack"] = stack_init(
            draw, ngroups,
            lambda: {
                "selfs": stack_init(
                    draw, gsize - 1,
                    lambda: self_block_params(draw, cfg, False)),
                "cross": cross_block_params(draw, cfg),
            })
    elif cfg.family == "ssm":
        params["stack"] = stack_init(draw, cfg.n_layers,
                                     lambda: ssm_block_params(draw, cfg))
    elif cfg.family == "hybrid":
        params["stack"] = stack_init(
            draw, ngroups,
            lambda: stack_init(draw, gsize,
                               lambda: ssm_block_params(draw, cfg)))
        params["shared_attn"] = shared_attn_params(draw, cfg)
    else:
        raise ValueError(f"lm.init: unsupported family {cfg.family}")
    return params


# ------------------------------------------------------------- forward

def _logits(params, x, cfg, ctx: ShardingCtx = NULL_CTX):
    x = _norm(params["ln_f"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:   # mask the padding rows
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    if ctx.seq is not None and logits.shape[1] > 1:
        return ctx.ct(logits, ctx.batch, ctx.seq, None)
    return ctx.ct(logits, ctx.batch, None, ctx.model)


def _call(body, *args):
    return body(*args)


def _checkpointed(cfg: ArchConfig):
    """Runs ``body(*args)`` -> (x, cache, aux) under `_remat`, the cache
    dropped inside it: returns (x, None, aux).  The body's run again in
    the backward pass records its spans as a replay of the step's
    (``obs.replay``): its counters count the forward once."""
    def run(body, *args):
        rec = obs.active()
        calls = [0]

        def no_cache(*a):
            calls[0] += 1
            with obs.replay(rec if calls[0] > 1 else None):
                x, _, aux = body(*a)
            return x, aux
        x, aux = _remat(no_cache, cfg)(*args)
        return x, None, aux
    return run


def _stack_loop(run, body, x, stacked, aux):
    """``body(x, layer)`` -> (x, cache, aux) over the layers of ``stacked``
    through ``run`` (the reference's ``stack_scan``): returns (x, the
    layers' caches, aux summed)."""
    caches = []
    for lp in _layers(stacked):
        x, c, a = run(body, x, lp)
        aux = aux + a
        caches.append(c)
    return x, caches, aux


def forward(params, tokens, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX,
            *, image_embeds=None, mode: str = "train"):
    """Full-sequence forward.  Returns (logits, caches, aux_loss).
    ``mode="prefill"`` returns the caches decoding continues from;
    ``mode="train"`` runs the reference's checkpointed bodies under
    `_remat` and returns an empty cache dict.  ``ctx`` places the
    reference's activation hints (DTensors on a mesh) and routes MoE
    layers through the expert-parallel island."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode must be 'train' or 'prefill', "
                         f"got {mode!r}")
    train = mode == "train"
    run = _checkpointed(cfg) if train else _call
    B, S = tokens.shape
    # an embedding lookup, whose backward sums each row's grads in a fixed
    # order on the card too (an index's backward scatters with atomics)
    x = ctx.ct(torch.nn.functional.embedding(tokens, params["embed"]),
               ctx.batch, None, None)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}

    if cfg.family in ("dense", "moe"):
        head_caches = []
        for hb in params.get("head_blocks", []):
            # head blocks are dense even in MoE archs (DeepSeek layer 0)
            x, c, _ = self_block_apply(hb, x, cfg=cfg, positions=positions,
                                       window=cfg.sliding_window, ctx=ctx)
            head_caches.append(c)
        caches["head"] = head_caches

        def body(x, lp):
            x, c, a = self_block_apply(lp, x, cfg=cfg, positions=positions,
                                       window=cfg.sliding_window, ctx=ctx)
            return ctx.ct(x, ctx.batch, ctx.seq, None), c, a

    elif cfg.family == "vlm":
        memory = image_embeds.to(x.dtype)

        def body(x, gp):
            selfs = []
            for sp in _layers(gp["selfs"]):
                x, c, _ = self_block_apply(sp, x, cfg=cfg,
                                           positions=positions, ctx=ctx)
                selfs.append(c)
            x, mem_kv = cross_block_apply(gp["cross"], x, memory, cfg=cfg,
                                          ctx=ctx)
            x = ctx.ct(x, ctx.batch, ctx.seq, None)
            return x, None if train else {"selfs": tree_stack(selfs),
                                          "mem_kv": mem_kv}, 0.0

    elif cfg.family == "ssm":
        def body(x, lp):
            y, st = ssm_mod.ssm_apply(lp["ssm"], _norm(lp["ln"], x, cfg),
                                      cfg=cfg)
            return ctx.ct(x + y, ctx.batch, ctx.seq, None), st, 0.0

    elif cfg.family == "hybrid":
        x_emb0 = x
        shared = params["shared_attn"]

        def body(x, gp):
            states = []
            for lp in _layers(gp):
                y, st = ssm_mod.ssm_apply(lp["ssm"], _norm(lp["ln"], x, cfg),
                                          cfg=cfg)
                x = x + y
                states.append(st)
            h = torch.cat([x, x_emb0], -1) @ shared["in_proj"]
            h2, kv, _ = self_block_apply(shared["block"], h, cfg=cfg,
                                         positions=positions,
                                         window=cfg.sliding_window, ctx=ctx)
            return (ctx.ct(x + h2, ctx.batch, ctx.seq, None),
                    None if train else {"ssm": tree_stack(states),
                                        "attn_kv": kv}, 0.0)
    else:
        raise ValueError(cfg.family)

    x, stack, aux = _stack_loop(run, body, x, params["stack"], aux)
    if train:
        return _logits(params, x, cfg, ctx), {}, aux
    caches["stack"] = tree_stack(stack)
    return _logits(params, x, cfg, ctx), caches, aux


def _n_layers(stacked) -> int:
    """Length of the leading (layer) axis of a stacked tree."""
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


# ---------------------------------------------------------- decode step

def decode_step(params, token, caches, pos, cfg: ArchConfig,
                ctx: ShardingCtx = NULL_CTX, *, image_embeds=None):
    """One decode step.  token [B, 1] int; pos the write index (an int or
    a 0-d tensor).  Caches carry [n_layers, ...] stacked KV / SSM state;
    each layer's slice is updated in place.  Returns (logits [B, 1, V],
    caches).  ``image_embeds`` is unused: the VLM's cross k/v live in the
    cache."""
    pos = int(pos)
    B = token.shape[0]
    x = params["embed"][token]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)

    if cfg.family in ("dense", "moe"):
        for hb, c in zip(params.get("head_blocks", []), caches["head"]):
            x, _, _ = self_block_apply(hb, x, cfg=cfg, positions=positions,
                                       cache=c, pos=pos,
                                       window=cfg.sliding_window, ctx=ctx)
        for i in range(_n_layers(params["stack"])):
            x, _, _ = self_block_apply(tree_at(params["stack"], i), x,
                                       cfg=cfg, positions=positions,
                                       cache=tree_at(caches["stack"], i),
                                       pos=pos, window=cfg.sliding_window,
                                       ctx=ctx)

    elif cfg.family == "vlm":
        for i in range(_n_layers(params["stack"])):
            gp, gc = tree_at(params["stack"], i), tree_at(caches["stack"], i)
            for j in range(_n_layers(gp["selfs"])):
                x, _, _ = self_block_apply(tree_at(gp["selfs"], j), x,
                                           cfg=cfg, positions=positions,
                                           cache=tree_at(gc["selfs"], j),
                                           pos=pos, ctx=ctx)
            x, _ = cross_block_apply(gp["cross"], x, None, cfg=cfg,
                                     mem_kv=gc["mem_kv"], ctx=ctx)

    elif cfg.family == "ssm":
        for i in range(_n_layers(params["stack"])):
            lp = tree_at(params["stack"], i)
            y, _ = ssm_mod.ssm_decode_step(
                lp["ssm"], _norm(lp["ln"], x, cfg),
                tree_at(caches["stack"], i), cfg=cfg)
            x = x + y

    elif cfg.family == "hybrid":
        x_emb0 = x
        shared = params["shared_attn"]
        for i in range(_n_layers(params["stack"])):
            gp, gc = tree_at(params["stack"], i), tree_at(caches["stack"], i)
            for j in range(_n_layers(gp)):
                lp = tree_at(gp, j)
                y, _ = ssm_mod.ssm_decode_step(
                    lp["ssm"], _norm(lp["ln"], x, cfg),
                    tree_at(gc["ssm"], j), cfg=cfg)
                x = x + y
            h = torch.cat([x, x_emb0], -1) @ shared["in_proj"]
            h2, _, _ = self_block_apply(shared["block"], h, cfg=cfg,
                                        positions=positions,
                                        cache=gc["attn_kv"], pos=pos,
                                        window=cfg.sliding_window, ctx=ctx)
            x = x + h2
    else:
        raise ValueError(cfg.family)

    return _logits(params, x, cfg, ctx), caches


# -------------------------------------------------------------- training

def loss_fn(params, batch, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """Mean token cross-entropy of ``forward(mode="train")`` plus 0.01 x
    the MoE load-balance loss."""
    logits, _, aux = forward(params, batch["tokens"], cfg, ctx,
                             image_embeds=batch.get("image_embeds"),
                             mode="train")
    return softmax_xent(logits, batch["labels"]) + 0.01 * aux
