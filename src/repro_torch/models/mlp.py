"""Feed-forward blocks: SwiGLU (llama family) and GeLU (seamless/enc-dec)
(counterpart of ``repro.models.mlp``)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import NULL_CTX, Draw, ShardingCtx, dense_init


def mlp_params(draw: Draw, d_model: int, d_ff: int, act: str = "silu"):
    p = {"wi": dense_init(draw, d_model, d_ff),
         "wo": dense_init(draw, d_ff, d_model)}
    if act == "silu":                     # SwiGLU needs the gate projection
        p["wg"] = dense_init(draw, d_model, d_ff)
    return p


def mlp_apply(p, x, *, act: str = "silu", ctx: ShardingCtx = NULL_CTX):
    h = x @ p["wi"]
    if act == "silu":
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default form
    # no hint on the hidden: the column-parallel wi/wg already shard it
    return ctx.ct_seq(h @ p["wo"])
