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
step writes its caches in place and returns them.  Activation
checkpointing (the reference's ``_remat``) and ``loss_fn`` belong to
training, which is not ported yet: ``mode="train"`` returns what
``mode="prefill"`` returns.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Draw, dense_init, embed_init,
                                       layernorm, rmsnorm, stack_init,
                                       tree_at, tree_stack)


# ---------------------------------------------------------------- blocks

def _norm(params, x, cfg):
    if cfg.norm == "rms":
        return rmsnorm(x, params["w"])
    return layernorm(x, params["w"], params["b"])


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
                     pos=None, window: int = 0):
    """Pre-norm attn + FFN.  Returns (x, cache, aux)."""
    h = _norm(p["ln1"], x, cfg)
    apply = attn.mla_apply if cfg.attn_type == "mla" else attn.gqa_apply
    a, new_cache = apply(p["attn"], h, cfg=cfg, positions=positions,
                         cache=cache, pos=pos, window=window)
    x = x + a
    h = _norm(p["ln2"], x, cfg)
    if "moe" in p:
        f, aux = moe_mod.moe_apply(p["moe"], h, cfg=cfg)
    else:
        f, aux = mlp_mod.mlp_apply(p["mlp"], h, act=cfg.act), 0.0
    return x + f, new_cache, aux


def cross_block_params(draw: Draw, cfg: ArchConfig):
    return {"ln1": _norm_params(draw, cfg), "ln2": _norm_params(draw, cfg),
            "xattn": attn.cross_params(draw, cfg),
            "mlp": mlp_mod.mlp_params(draw, cfg.d_model, cfg.d_ff, cfg.act),
            "gate": draw.full((1,), 0.0)}


def cross_block_apply(p, x, memory, *, cfg, mem_kv=None):
    h = _norm(p["ln1"], x, cfg)
    a, mem_kv = attn.cross_apply(p["xattn"], h, memory, cfg=cfg,
                                 mem_kv=mem_kv)
    x = x + torch.tanh(p["gate"]) * a
    h = _norm(p["ln2"], x, cfg)
    return x + mlp_mod.mlp_apply(p["mlp"], h, act=cfg.act), mem_kv


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

def _logits(params, x, cfg):
    x = _norm(params["ln_f"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:   # mask the padding rows
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    return logits


def forward(params, tokens, cfg: ArchConfig, *, image_embeds=None,
            mode: str = "train"):
    """Full-sequence forward.  Returns (logits, caches, aux_loss): the
    caches are those ``mode="prefill"`` hands to decoding (``mode="train"``
    returns the same)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode must be 'train' or 'prefill', "
                         f"got {mode!r}")
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    caches: Dict[str, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ("dense", "moe"):
        head_caches = []
        for hb in params.get("head_blocks", []):
            # head blocks are dense even in MoE archs (DeepSeek layer 0)
            x, c, _ = self_block_apply(hb, x, cfg=cfg, positions=positions,
                                       window=cfg.sliding_window)
            head_caches.append(c)
        caches["head"] = head_caches
        stack = []
        for i in range(_n_layers(params["stack"])):
            x, c, a = self_block_apply(tree_at(params["stack"], i), x,
                                       cfg=cfg, positions=positions,
                                       window=cfg.sliding_window)
            aux_total = aux_total + a
            stack.append(c)
        caches["stack"] = tree_stack(stack)

    elif cfg.family == "vlm":
        memory = image_embeds.to(x.dtype)
        stack = []
        for i in range(_n_layers(params["stack"])):
            gp = tree_at(params["stack"], i)
            selfs = []
            for j in range(_n_layers(gp["selfs"])):
                x, c, _ = self_block_apply(tree_at(gp["selfs"], j), x,
                                           cfg=cfg, positions=positions)
                selfs.append(c)
            x, mem_kv = cross_block_apply(gp["cross"], x, memory, cfg=cfg)
            stack.append({"selfs": tree_stack(selfs), "mem_kv": mem_kv})
        caches["stack"] = tree_stack(stack)

    elif cfg.family == "ssm":
        stack = []
        for i in range(_n_layers(params["stack"])):
            lp = tree_at(params["stack"], i)
            y, st = ssm_mod.ssm_apply(lp["ssm"], _norm(lp["ln"], x, cfg),
                                      cfg=cfg)
            x = x + y
            stack.append(st)
        caches["stack"] = tree_stack(stack)

    elif cfg.family == "hybrid":
        x_emb0 = x
        shared = params["shared_attn"]
        stack = []
        for i in range(_n_layers(params["stack"])):
            gp = tree_at(params["stack"], i)
            states = []
            for j in range(_n_layers(gp)):
                lp = tree_at(gp, j)
                y, st = ssm_mod.ssm_apply(lp["ssm"], _norm(lp["ln"], x, cfg),
                                          cfg=cfg)
                x = x + y
                states.append(st)
            h = torch.cat([x, x_emb0], -1) @ shared["in_proj"]
            h2, kv, _ = self_block_apply(shared["block"], h, cfg=cfg,
                                         positions=positions,
                                         window=cfg.sliding_window)
            x = x + h2
            stack.append({"ssm": tree_stack(states), "attn_kv": kv})
        caches["stack"] = tree_stack(stack)
    else:
        raise ValueError(cfg.family)

    return _logits(params, x, cfg), caches, aux_total


def _n_layers(stacked) -> int:
    """Length of the leading (layer) axis of a stacked tree."""
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


# ---------------------------------------------------------- decode step

def decode_step(params, token, caches, pos, cfg: ArchConfig, *,
                image_embeds=None):
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
                                       window=cfg.sliding_window)
        for i in range(_n_layers(params["stack"])):
            x, _, _ = self_block_apply(tree_at(params["stack"], i), x,
                                       cfg=cfg, positions=positions,
                                       cache=tree_at(caches["stack"], i),
                                       pos=pos, window=cfg.sliding_window)

    elif cfg.family == "vlm":
        for i in range(_n_layers(params["stack"])):
            gp, gc = tree_at(params["stack"], i), tree_at(caches["stack"], i)
            for j in range(_n_layers(gp["selfs"])):
                x, _, _ = self_block_apply(tree_at(gp["selfs"], j), x,
                                           cfg=cfg, positions=positions,
                                           cache=tree_at(gc["selfs"], j),
                                           pos=pos)
            x, _ = cross_block_apply(gp["cross"], x, None, cfg=cfg,
                                     mem_kv=gc["mem_kv"])

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
                                        window=cfg.sliding_window)
            x = x + h2
    else:
        raise ValueError(cfg.family)

    return _logits(params, x, cfg), caches
