"""Architecture registry: ``--arch <id>`` resolution + input specs
(counterpart of ``repro.configs``).

`input_specs(cfg, shape, make=...)` builds the model inputs of each
(architecture x shape) cell: meta-device tensors by default (no
allocation), or materialized tensors with another ``make(shape, dtype)``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeSpec, SHAPES, SMOKE_SHAPES, MoESpec, MLASpec, SSMSpec)

ARCH_IDS = (
    "granite-3-2b",
    "mistral-large-123b",
    "qwen2-72b",
    "smollm-360m",
    "llama-3.2-vision-11b",
    "mamba2-780m",
    "deepseek-v2-lite-16b",
    "olmoe-1b-7b",
    "zamba2-2.7b",
    "seamless-m4t-medium",
)

# long_500k only for the sub-quadratic families (SSM / hybrid); all others
# are full attention
LONG_CONTEXT_ARCHS = ("mamba2-780m", "zamba2-2.7b")


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def cell_supported(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


def meta_tensor(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the meta device (no data)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                make=meta_tensor) -> Dict[str, Any]:
    """Model inputs for one cell; `make(shape, dtype)` builds each leaf.

    train  -> {tokens, labels [, image_embeds | frames]}
    prefill-> {tokens [, image_embeds | frames]}
    decode -> {token [B,1], pos scalar} (+ cache specs, built separately)
    """
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind == "train":
        d: Dict[str, Any] = {"tokens": make((B, S), tok),
                             "labels": make((B, S), tok)}
        if cfg.family == "vlm":
            d["image_embeds"] = make((B, cfg.frontend_tokens, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "audio":
            d["frames"] = make((B, S, cfg.d_model), torch.bfloat16)
        return d
    if shape.kind == "prefill":
        d = {"tokens": make((B, S), tok)}
        if cfg.family == "vlm":
            d["image_embeds"] = make((B, cfg.frontend_tokens, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "audio":
            d["frames"] = make((B, S, cfg.d_model), torch.bfloat16)
        return d
    # decode: one new token against a cache of length S
    return {"token": make((B, 1), tok), "pos": make((), torch.int32)}
