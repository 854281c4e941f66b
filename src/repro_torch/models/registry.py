"""Family dispatch: one uniform interface over decoder and enc-dec models,
plus the decode caches and their shapes (counterpart of
``repro.models.registry``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import COMPUTE_DTYPE

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def build(cfg: ArchConfig):
    """Returns the module implementing init/forward/decode_step."""
    return encdec if cfg.family == "audio" else lm


def _cache_tree(cfg: ArchConfig, B: int, S: int,
                make: Callable[..., Any]) -> Dict[str, Any]:
    """Cache tree for a decode step, leaves built by `make(shape, dtype)`:
    the structure forward(mode='prefill') emits.  The sliding window's
    attention cache holds min(S, window) positions."""
    hd = cfg.hd

    def kv(prefix=(), length=S):
        if cfg.attn_type == "mla":
            m = cfg.mla
            return {"ckv": make((*prefix, B, length, m.kv_lora), COMPUTE_DTYPE),
                    "kr": make((*prefix, B, length, m.qk_rope), COMPUTE_DTYPE)}
        return {"k": make((*prefix, B, length, cfg.n_kv_heads, hd),
                          COMPUTE_DTYPE),
                "v": make((*prefix, B, length, cfg.n_kv_heads, hd),
                          COMPUTE_DTYPE)}

    def ssm_state(prefix=()):
        d_inner, H, conv_ch = ssm_mod.ssm_dims(cfg)
        s = cfg.ssm
        return {"h": make((*prefix, B, H, s.state, s.headdim), torch.float32),
                "conv": make((*prefix, B, s.conv_width - 1, conv_ch),
                             COMPUTE_DTYPE)}

    win = min(S, cfg.sliding_window) if cfg.sliding_window else S
    if cfg.family in ("dense", "moe"):
        n_scan = cfg.n_layers - cfg.dense_first_n
        return {"head": [kv() for _ in range(cfg.dense_first_n)],
                "stack": kv(prefix=(n_scan,))}
    if cfg.family == "vlm":
        g = cfg.cross_attn_every
        ng = cfg.n_layers // g
        return {"stack": {
            "selfs": kv(prefix=(ng, g - 1)),
            "mem_kv": {"mk": make((ng, B, cfg.frontend_tokens, cfg.n_heads, hd),
                                  COMPUTE_DTYPE),
                       "mv": make((ng, B, cfg.frontend_tokens, cfg.n_heads, hd),
                                  COMPUTE_DTYPE)}}}
    if cfg.family == "ssm":
        return {"stack": ssm_state(prefix=(cfg.n_layers,))}
    if cfg.family == "hybrid":
        g = cfg.shared_attn_every
        ng = cfg.n_layers // g
        return {"stack": {"ssm": ssm_state(prefix=(ng, g)),
                          "attn_kv": kv(prefix=(ng,), length=win)}}
    if cfg.family == "audio":
        return {"stack": {
            "kv": kv(prefix=(cfg.n_layers,)),
            "mem_kv": {"mk": make((cfg.n_layers, B, S, cfg.n_heads, hd),
                                  COMPUTE_DTYPE),
                       "mv": make((cfg.n_layers, B, S, cfg.n_heads, hd),
                                  COMPUTE_DTYPE)}}}
    raise ValueError(cfg.family)


def cache_zeros(cfg: ArchConfig, B: int, S: int, *, device="cuda"):
    """Materialized zero cache on ``device`` (the serving loop's)."""
    dev = resolve_device(device)
    return _cache_tree(cfg, B, S, lambda shape, dt: torch.zeros(
        shape, dtype=dt, device=dev))


def cache_specs(cfg: ArchConfig, B: int, S: int):
    """The decode cache as meta tensors (shapes and dtypes, no
    allocation): what the dry run shards."""
    return _cache_tree(cfg, B, S, lambda shape, dt: torch.empty(
        shape, dtype=dt, device="meta"))
