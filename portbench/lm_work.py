"""The LM cells' yardstick: the card's bfloat16 peak and the model FLOPs
that a step needs, from its shape, its tokens and the rows its held
experts were counted to compute, whatever implements it.

A product of an [m, k] and a [k, n] operand is 2 m k n operations.  The
forward's products are the projections of every token (attention's,
the dense and shared FFNs', the router's and the head's), the held
experts' three products over their counted rows, and causal attention's
scores and values (the (S + 1) / 2 keys a query sees on average); the
backward takes twice the forward's, so a step is 3 x the forward.  What
the implementation does beyond that (the padded key blocks of chunked
attention, the recomputation of activation checkpointing, the masked
rows of the dropless layer) is not counted in a step; a region's
roofline counts each pass of the forward that runs in it.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet: dense bfloat16 on the tensor cores (700 W)
BF16_FLOPS_PER_S = 989.4e12


class Shape(NamedTuple):
    """What the counts need of a DeepSeek-V2-style model and its batch."""
    batch: int
    seq: int
    d_model: int
    n_heads: int
    qk_nope: int
    qk_rope: int
    v_head: int
    kv_lora: int
    d_ff: int             # the dense layers' FFN width
    d_expert: int
    n_experts: int        # the router's width
    n_shared: int
    vocab: int
    n_dense: int          # leading dense layers
    n_moe: int            # MoE layers
    n_remat: int          # layers whose forward runs again in the backward

    @property
    def tokens(self) -> int:
        return self.batch * self.seq

    @property
    def n_layers(self) -> int:
        return self.n_dense + self.n_moe


def as_shape(d: dict) -> Shape:
    return Shape(**{k: int(d[k]) for k in Shape._fields})


def attention_params(s: Shape) -> int:
    """MLA's projection weights a token passes through, one layer."""
    H, D = s.n_heads, s.d_model
    return (D * H * (s.qk_nope + s.qk_rope) + D * (s.kv_lora + s.qk_rope)
            + s.kv_lora * H * (s.qk_nope + s.v_head) + H * s.v_head * D)


def token_params(s: Shape) -> int:
    """Weights every token passes through in one forward, the routed
    experts apart."""
    ffn = 3 * s.d_model
    return (s.n_layers * attention_params(s) + s.n_dense * ffn * s.d_ff
            + s.n_moe * (ffn * s.n_shared * s.d_expert
                         + s.d_model * s.n_experts)
            + s.d_model * s.vocab)


def expert_flops(s: Shape, rows: float) -> float:
    """The held experts' three products over ``rows`` counted rows."""
    return 2.0 * rows * 3 * s.d_model * s.d_expert


def attention_flops(s: Shape, layers: int) -> float:
    """Causal scores and values of ``layers`` layers over the batch."""
    pairs = s.batch * s.seq * (s.seq + 1) / 2
    return (2.0 * pairs * s.n_heads * (s.qk_nope + s.qk_rope + s.v_head)
            * layers)


def forward_flops(s: Shape, moe_rows: float) -> float:
    """One forward over the batch, ``moe_rows`` the rows the held experts
    computed, summed over the MoE layers."""
    return (2.0 * s.tokens * token_params(s) + expert_flops(s, moe_rows)
            + attention_flops(s, s.n_layers))


def step_flops(s: Shape, moe_rows: float) -> float:
    """The model FLOPs of one training step: forward and backward."""
    return 3.0 * forward_flops(s, moe_rows)


def experts_region_flops(s: Shape, moe_rows: float) -> float:
    """What runs under ``lm.moe.experts``: the held experts' products in
    the forward and in its run again in the backward (the MoE layers are
    all in the checkpointed stack when ``n_remat`` covers them)."""
    passes = 1 + min(s.n_remat, s.n_moe) / s.n_moe if s.n_moe else 1
    return expert_flops(s, moe_rows) * passes


def attend_region_flops(s: Shape) -> float:
    """What runs under ``lm.mla.attend``: causal scores and values in the
    forward of every layer and again for the checkpointed ones."""
    return attention_flops(s, s.n_layers + s.n_remat)
