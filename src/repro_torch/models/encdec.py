"""Encoder-decoder backbone (seamless-m4t family) (counterpart of
``repro.models.encdec``).

The audio frontend is a stub: `frames` are precomputed frame embeddings
[B, S_enc, d_model].  Encoder: bidirectional self-attn + GeLU FFN.
Decoder: causal self-attn (cached) + cross-attn to the encoder output
(memory k/v cached once) + GeLU FFN.  ``mode="train"`` runs each encoder
and decoder layer under activation checkpointing by ``cfg.remat_policy``
(``lm._remat``) and keeps no caches; ``loss_fn`` is the training loss
(cross-entropy, no aux term).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (COMPUTE_DTYPE, NULL_CTX, Draw,
                                       ShardingCtx, apply_rope, dense_init,
                                       embed_init, rope_freqs, softmax_xent,
                                       stack_init, tree_at, tree_stack)
from repro_torch.models.lm import (_call, _checkpointed, _logits, _n_layers,
                                   _norm, _norm_params, _stack_loop,
                                   cross_block_apply, cross_block_params,
                                   self_block_apply, self_block_params)


def enc_block_params(draw: Draw, cfg: ArchConfig):
    return {"ln1": _norm_params(draw, cfg), "ln2": _norm_params(draw, cfg),
            "attn": attn.gqa_params(draw, cfg),
            "mlp": mlp_mod.mlp_params(draw, cfg.d_model, cfg.d_ff, cfg.act)}


def enc_block_apply(p, x, *, cfg, positions, ctx: ShardingCtx = NULL_CTX):
    """Bidirectional self-attention block (no mask, no cache)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = _norm(p["ln1"], x, cfg)
    q = (h @ p["attn"]["wq"]).reshape(B, S, H, hd)
    k = (h @ p["attn"]["wk"]).reshape(B, S, KV, hd)
    v = (h @ p["attn"]["wv"]).reshape(B, S, KV, hd)
    inv = rope_freqs(hd, cfg.rope_theta, x.device)
    q, k = apply_rope(q, positions, inv), apply_rope(k, positions, inv)
    qg = q.reshape(B, S, KV, H // KV, hd).transpose(2, 3)
    out = attn.chunked_attend(qg, k, v, causal=False, window=0,
                              scale=hd ** -0.5, chunk=cfg.attn_chunk)
    out = out.transpose(2, 3).reshape(B, S, H * hd)
    x = x + out @ p["attn"]["wo"]
    h = _norm(p["ln2"], x, cfg)
    return x + mlp_mod.mlp_apply(p["mlp"], h, act=cfg.act, ctx=ctx)


def dec_block_params(draw: Draw, cfg: ArchConfig):
    p = self_block_params(draw, cfg, use_moe=False)
    p["cross"] = cross_block_params(draw, cfg)
    return p


def dec_block_apply(p, x, memory, *, cfg, positions, cache=None, pos=None,
                    ctx: ShardingCtx = NULL_CTX):
    x, kv, _ = self_block_apply({k: v for k, v in p.items() if k != "cross"},
                                x, cfg=cfg, positions=positions,
                                cache=None if cache is None else cache["kv"],
                                pos=pos, ctx=ctx)
    x, mem_kv = cross_block_apply(p["cross"], x, memory, cfg=cfg,
                                  mem_kv=None if cache is None
                                  else cache["mem_kv"], ctx=ctx)
    return x, {"kv": kv, "mem_kv": mem_kv}


def init(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random params from ``seed`` on ``device`` (see ``lm.init``)."""
    draw = Draw(resolve_device(device), seed)
    n_enc = cfg.enc_layers or cfg.n_layers
    return {
        "embed": embed_init(draw, cfg.padded_vocab, cfg.d_model),
        "lm_head": dense_init(draw, cfg.d_model, cfg.padded_vocab),
        "ln_f": _norm_params(draw, cfg),
        "ln_enc": _norm_params(draw, cfg),
        "enc": stack_init(draw, n_enc, lambda: enc_block_params(draw, cfg)),
        "dec": stack_init(draw, cfg.n_layers,
                          lambda: dec_block_params(draw, cfg)),
    }


def encode(params, frames, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX,
           remat: bool = False):
    """The encoder over ``frames``; with ``remat`` each layer runs under
    activation checkpointing."""
    B, S, _ = frames.shape
    x = frames.to(COMPUTE_DTYPE)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)

    def body(x, lp):
        y = enc_block_apply(lp, x, cfg=cfg, positions=positions, ctx=ctx)
        return ctx.ct(y, ctx.batch, ctx.seq, None), None, 0.0

    run = _checkpointed(cfg) if remat else _call
    x, _, _ = _stack_loop(run, body, x, params["enc"], 0.0)
    return _norm(params["ln_enc"], x, cfg)


def forward(params, tokens, frames, cfg: ArchConfig,
            ctx: ShardingCtx = NULL_CTX, mode: str = "train"):
    """Teacher-forced decoder over `tokens` given encoder `frames`.
    Returns (logits, caches, aux_loss); ``mode`` as in ``lm.forward``."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode must be 'train' or 'prefill', "
                         f"got {mode!r}")
    train = mode == "train"
    memory = encode(params, frames, cfg, ctx, remat=train)
    B, S = tokens.shape
    x = torch.nn.functional.embedding(tokens, params["embed"])
    positions = torch.arange(S, device=x.device)[None].expand(B, S)

    def body(x, lp):
        x, c = dec_block_apply(lp, x, memory, cfg=cfg, positions=positions,
                               ctx=ctx)
        return ctx.ct(x, ctx.batch, ctx.seq, None), c, 0.0

    run = _checkpointed(cfg) if train else _call
    x, caches, _ = _stack_loop(run, body, x, params["dec"], 0.0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (_logits(params, x, cfg, ctx),
            {} if train else {"stack": tree_stack(caches)}, aux)


def decode_step(params, token, caches, pos, cfg: ArchConfig,
                ctx: ShardingCtx = NULL_CTX):
    """One decoder step; cross k/v and self KV cache come from `caches`,
    whose self KV slices are written in place."""
    pos = int(pos)
    B = token.shape[0]
    x = params["embed"][token]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(_n_layers(params["dec"])):
        x, _ = dec_block_apply(tree_at(params["dec"], i), x, None, cfg=cfg,
                               positions=positions,
                               cache=tree_at(caches["stack"], i), pos=pos,
                               ctx=ctx)
    return _logits(params, x, cfg, ctx), caches


def loss_fn(params, batch, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """Mean token cross-entropy of ``forward(mode="train")``."""
    logits, _, _ = forward(params, batch["tokens"], batch["frames"], cfg, ctx,
                           mode="train")
    return softmax_xent(logits, batch["labels"])
