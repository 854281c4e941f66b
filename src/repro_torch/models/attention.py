"""Attention variants: GQA (with optional QKV bias + sliding window), MLA
(DeepSeek multi-head latent attention, absorbed decode form) and
cross-attention (VLM / enc-dec memory) (counterpart of
``repro.models.attention``).

Cache contract (decode):
  GQA   cache = {"k": [B, S, KV, hd], "v": [B, S, KV, hd]}
  MLA   cache = {"ckv": [B, S, kv_lora], "kr": [B, S, qk_rope]}
  cross cache = {"mk": [B, M, H, hd], "mv": [B, M, H, hd]}  (static memory)
`pos` (an int) is the write index; queries attend to cache positions
<= pos.  A decode step writes its keys and values into the cache tensors in
place and returns the same cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (NULL_CTX, Draw, ShardingCtx,
                                       apply_rope, dense_init, rmsnorm,
                                       rope_freqs, yarn_freqs, yarn_mscale)

# a finite mask value, as the reference's: a fully masked row gets a
# uniform softmax, not NaN
NEG_INF = -2.0e38


def _softmax_attend(qt, kt, vt, mask, scale):
    """The attention math on operands laid out for its two products:
    qt [B,G,Hk,Sq,hd], kt [B,1,Hk,hd,Skv], vt [B,1,Hk,Skv,hd]; ``mask``
    broadcasts to the scores [B,G,Hk,Sq,Skv], or is None (nothing masked).
    Returns [B,G,Hk,Sq,hd]."""
    scores = torch.matmul(qt, kt).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, -1).to(vt.dtype)
    return torch.matmul(w, vt)


def _attend(q, k, v, *, mask, scale):
    """q [B,Sq,G,Hk,hd] k/v [B,Skv,Hk,hd] (G = query groups per kv head);
    ``mask`` broadcasts to [B,G,Hk,Sq,Skv].  Returns [B,Sq,G,Hk,hd]."""
    out = _softmax_attend(q.permute(0, 2, 3, 1, 4),
                          k.permute(0, 2, 3, 1)[:, None],
                          v.permute(0, 2, 1, 3)[:, None], mask, scale)
    return out.permute(0, 3, 1, 2, 4)


def chunked_attend(q, k, v, *, causal: bool, window: int, scale: float,
                   chunk: int):
    """Attention over query blocks of ``chunk`` rows, so the live score
    buffer is [B, G, Hk, C, Skv].  q [B,Sq,G,Hk,hd], k/v [B,Skv,Hk,hd];
    q/kv positions are absolute [0..S).  Sq is padded up to a multiple of
    the block; the padded rows are computed and sliced away.  The operands
    are laid out for `_softmax_attend` and the mask is built once a call,
    not once a block.  A causal block stops at
    its last row's position: the keys past it would all be masked, and a
    masked score's weight is exactly 0, so the result is the reference's
    full-width one up to the order of the float sums."""
    B, Sq, G, Hk, hd = q.shape
    Skv = k.shape[1]
    C = min(chunk, Sq)
    pad = (-Sq) % C
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
    Sp = q.shape[1]
    qt = q.permute(0, 2, 3, 1, 4).contiguous()          # [B, G, Hk, Sp, hd]
    kt = k.permute(0, 2, 3, 1).contiguous()[:, None]    # [B, 1, Hk, hd, Skv]
    vt = v.permute(0, 2, 1, 3).contiguous()[:, None]    # [B, 1, Hk, Skv, hd]
    mask = None
    if causal:
        i = torch.arange(Sp, device=q.device)[:, None]
        j = torch.arange(Skv, device=q.device)[None, :]
        mask = j <= i
        if window:
            mask = mask & (j > i - window)
    outs = []
    for start in range(0, Sp, C):
        end = min(start + C, Skv) if causal else Skv
        outs.append(_softmax_attend(                      # [B, G, Hk, C, hd]
            qt[:, :, :, start:start + C], kt[..., :end], vt[:, :, :, :end],
            None if mask is None else mask[start:start + C, :end], scale))
    return torch.cat(outs, 3)[:, :, :, :Sq].permute(0, 3, 1, 2, 4)


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``new`` [B, S, ...] into ``cache`` [B, Sc, ...] at ``pos`` in
    place.  The start is clamped so that the update fits, as
    ``jax.lax.dynamic_update_slice`` clamps it in the reference: a write
    past the end lands on the last rows."""
    start = min(max(pos, 0), cache.shape[1] - new.shape[1])
    cache[:, start:start + new.shape[1]] = new
    return cache


# ---------------------------------------------------------------- GQA

def _repeat_kv(t: torch.Tensor, G: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, KV * G, hd], each head repeated G times in
    place (``repeat_interleave``'s layout), by an expand: its backward is a
    sum over the copies in a fixed order, not a scatter with atomics."""
    B, S, KV, hd = t.shape
    return t[:, :, :, None].expand(B, S, KV, G, hd).reshape(B, S, KV * G, hd)


def gqa_params(draw: Draw, cfg: ArchConfig):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(draw, D, H * hd),
        "wk": dense_init(draw, D, KV * hd),
        "wv": dense_init(draw, D, KV * hd),
        "wo": dense_init(draw, H * hd, D),
    }
    if cfg.qkv_bias:
        p["bq"] = draw.full((H * hd,), 0.0)
        p["bk"] = draw.full((KV * hd,), 0.0)
        p["bv"] = draw.full((KV * hd,), 0.0)
    return p


def gqa_apply(p, x, *, cfg: ArchConfig, positions: torch.Tensor,
              cache: Optional[dict] = None, pos: Optional[int] = None,
              window: int = 0, ctx: ShardingCtx = NULL_CTX):
    """x [B, S, D].  Train/prefill: cache=None; decode: S==1 + cache."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    inv_freq = rope_freqs(hd, cfg.rope_theta, x.device)

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # only the merged-head projection is hinted (always divisible)
    q = ctx.ct(q, ctx.batch, None, ctx.model)
    q = apply_rope(q.reshape(B, S, H, hd), positions, inv_freq)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, inv_freq)
    v = v.reshape(B, S, KV, hd)

    if cache is not None and pos is not None:            # ---- decode step
        kc = _write(cache["k"], k, pos)
        vc = _write(cache["v"], v, pos)
        idx = torch.arange(kc.shape[1], device=x.device)
        valid = idx <= pos
        if window:
            valid = valid & (idx > pos - window)
        qg = q.reshape(B, S, KV, G, hd).transpose(2, 3)   # [B,S,G,KV,hd]
        out = _attend(qg, kc, vc, mask=valid[None, None, None, None, :],
                      scale=hd ** -0.5)
        out = out.transpose(2, 3).reshape(B, S, H * hd)
        return out @ p["wo"], {"k": kc, "v": vc}

    # ---- train / prefill: causal (optionally sliding-window) attention
    # over query blocks, KV heads repeated to the H query heads
    out = chunked_attend(q[:, :, None], _repeat_kv(k, G), _repeat_kv(v, G),
                         causal=True, window=window, scale=hd ** -0.5,
                         chunk=cfg.attn_chunk)
    out = ctx.ct(out[:, :, 0].reshape(B, S, H * hd), ctx.batch, None,
                 ctx.model)
    return ctx.ct_seq(out @ p["wo"]), {"k": k, "v": v}


# ---------------------------------------------------------------- MLA

def mla_params(draw: Draw, cfg: ArchConfig):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    return {
        "wq": dense_init(draw, D, H * (m.qk_nope + m.qk_rope)),
        "wdkv": dense_init(draw, D, m.kv_lora + m.qk_rope),
        "kv_norm": draw.full((m.kv_lora,), 1.0),
        "wuk": dense_init(draw, m.kv_lora, H * m.qk_nope),
        "wuv": dense_init(draw, m.kv_lora, H * m.v_head),
        "wo": dense_init(draw, H * m.v_head, D),
    }


def mla_rope(cfg: ArchConfig, device=None):
    """MLA's rope half: (inverse frequencies, the cos/sin factor, the
    softmax scale).  Plain RoPE and ``(dn + dr)^-0.5``; with
    ``cfg.rope_scaling`` YaRN's frequencies, cos and sin scaled by
    ``m(factor, mscale) / m(factor, mscale_all_dim)`` and the softmax
    scale by ``m(factor, mscale_all_dim)^2`` (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding`` and ``softmax_scale``)."""
    m, y = cfg.mla, cfg.rope_scaling
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    if y is None:
        return rope_freqs(m.qk_rope, cfg.rope_theta, device), 1.0, scale
    all_dim = yarn_mscale(y.factor, y.mscale_all_dim)
    return (yarn_freqs(m.qk_rope, cfg.rope_theta, y, device),
            yarn_mscale(y.factor, y.mscale) / all_dim,
            scale * all_dim * all_dim)


def mla_apply(p, x, *, cfg: ArchConfig, positions: torch.Tensor,
              cache: Optional[dict] = None, pos: Optional[int] = None,
              window: int = 0, ctx: ShardingCtx = NULL_CTX):
    """Decode scores the query against the compressed cache (wuk folded
    into the query, wuv applied after the weighted sum); train/prefill
    materializes k/v.  Decode ignores ``window``, as the reference does.
    The rope half's frequencies and the softmax scale are `mla_rope`'s."""
    B, S, D = x.shape
    m = cfg.mla
    H = cfg.n_heads
    dn, dr, dv = m.qk_nope, m.qk_rope, m.v_head
    inv_freq, rope_scale, scale = mla_rope(cfg, x.device)

    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, inv_freq, rope_scale)
    dkv = x @ p["wdkv"]                                       # [B,S,lora+dr]
    ckv = rmsnorm(dkv[..., :m.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora:][:, :, None, :], positions,
                        inv_freq, rope_scale)[:, :, 0, :]     # [B,S,dr] shared

    if cache is not None and pos is not None:                 # ---- decode
        ckv_c = _write(cache["ckv"], ckv, pos)
        kr_c = _write(cache["kr"], k_rope, pos)
        wuk = p["wuk"].reshape(m.kv_lora, H, dn)
        q_abs = torch.einsum("bshn,lhn->bshl", q_nope, wuk)   # [B,1,H,lora]
        scores = (torch.einsum("bshl,btl->bhst", q_abs, ckv_c)
                  + torch.einsum("bshr,btr->bhst", q_rope, kr_c))
        scores = scores.float() * scale
        valid = (torch.arange(ckv_c.shape[1], device=x.device)
                 <= pos)[None, None, None, :]
        w = torch.softmax(torch.where(valid, scores, NEG_INF), -1).to(x.dtype)
        ctx_l = torch.einsum("bhst,btl->bshl", w, ckv_c)      # [B,1,H,lora]
        wuv = p["wuv"].reshape(m.kv_lora, H, dv)
        out = torch.einsum("bshl,lhv->bshv", ctx_l, wuv).reshape(B, S, H * dv)
        return out @ p["wo"], {"ckv": ckv_c, "kr": kr_c}

    # ---- train / prefill: nope and rope parts concatenated along the head
    # dim, so one product computes q_nope.k_nope + q_rope.k_rope (the shared
    # k_rope broadcast to every head)
    k_nope = (ckv @ p["wuk"]).reshape(B, S, H, dn)
    v = (ckv @ p["wuv"]).reshape(B, S, H, dv)
    q_cat = torch.cat([q_nope, q_rope], -1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], -1)
    with obs.region("lm.mla.attend"):
        out = chunked_attend(q_cat[:, :, None], k_cat, v, causal=True,
                             window=window, scale=scale,
                             chunk=cfg.attn_chunk)
    out = out[:, :, 0].reshape(B, S, H * dv)
    return ctx.ct_seq(out @ p["wo"]), {"ckv": ckv, "kr": k_rope}


# --------------------------------------------------------------- cross

def cross_params(draw: Draw, cfg: ArchConfig, d_mem: Optional[int] = None):
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    d_mem = d_mem or D
    return {
        "wq": dense_init(draw, D, H * hd),
        "wk": dense_init(draw, d_mem, H * hd),
        "wv": dense_init(draw, d_mem, H * hd),
        "wo": dense_init(draw, H * hd, D),
    }


def cross_apply(p, x, memory, *, cfg: ArchConfig,
                mem_kv: Optional[dict] = None, ctx: ShardingCtx = NULL_CTX):
    """x [B,S,D] attends to memory [B,M,d_mem].  mem_kv caches k/v(memory)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if mem_kv is None:
        mem_kv = {"mk": (memory @ p["wk"]).reshape(B, -1, H, hd),
                  "mv": (memory @ p["wv"]).reshape(B, -1, H, hd)}
    k, v = mem_kv["mk"], mem_kv["mv"]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * hd ** -0.5
    w = torch.softmax(scores, -1).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, v).reshape(B, S, H * hd)
    return out @ p["wo"], mem_kv

