"""Architecture + shape configuration schema (the `--arch` / `--shape` axes).

One frozen dataclass tree per architecture lives in configs/<id>.py;
`reduced()` derives the CPU smoke-test variant of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    num_shared: int = 0            # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    # combine path: 'gather' (baseline — GSPMD all-gathers the [B,E,C,D]
    # buffer over the EP axis) or 'scatter' (slots scatter-add into token
    # order -> partial sums + all-reduce of [T,D]: k*cf/2 x fewer bytes).
    # §Perf iteration for the MoE cells; see EXPERIMENTS.md.
    combine: str = "gather"


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    state: int = 128               # N, the SSM state size
    headdim: int = 64              # P, channels per SSD head
    conv_width: int = 4
    expand: int = 2                # d_inner = expand * d_model
    chunk: int = 128               # SSD chunk length
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    attn_type: str = "gqa"         # gqa | mla
    norm: str = "rms"              # rms | ln
    act: str = "silu"              # silu | gelu
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    dense_first_n: int = 0         # first N layers use dense FFN (DeepSeek)
    cross_attn_every: int = 0      # VLM: a cross-attn layer every N layers
    frontend_tokens: int = 1601    # VLM/audio stub: embeddings supplied per item
    shared_attn_every: int = 0     # Zamba2: shared attn block every N SSM layers
    sliding_window: int = 0        # 0 = full attention
    enc_layers: int = 0            # audio enc-dec: encoder depth (dec = n_layers)
    scan_layers: bool = True       # False: unroll stacks (cost-analysis probes —
                                   # XLA while-body costs are counted once)
    attn_chunk: int = 512          # q-block size for chunked attention
    remat_policy: str = "full"     # 'full' (save nothing) | 'dots' (save
                                   # matmul outputs: no fwd recompute in bwd,
                                   # -15-20% on all three roofline terms, but
                                   # +10-40 GB live on >=2B archs -> only the
                                   # sub-1B configs enable it; EXPERIMENTS §Perf)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/lm_head vocab
        dim divides every mesh axis (jit argument shardings require exact
        divisibility).  Padded logit rows are masked to -inf in the head —
        the output distribution over the true vocab is exact."""
        return -(-self.vocab_size // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Same family, CPU-smoke scale (layers/width/vocab/experts shrunk)."""
        small = dataclasses.replace(
            self,
            vocab_size=min(self.vocab_size, 512),
            d_model=128,
            n_layers=min(self.n_layers, 4) if not self.shared_attn_every
            else 2 * self.shared_attn_every,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads
            else 4,
            d_ff=256 if self.d_ff else 0,
            head_dim=32 if self.head_dim else 0,
            frontend_tokens=16,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            dense_first_n=min(self.dense_first_n, 1),
            cross_attn_every=min(self.cross_attn_every, 2) if self.cross_attn_every else 0,
        )
        if self.moe:
            small = dataclasses.replace(
                small, moe=dataclasses.replace(self.moe, num_experts=8,
                                               top_k=min(self.moe.top_k, 2),
                                               d_expert=64))
        if self.mla:
            small = dataclasses.replace(
                small, mla=MLASpec(kv_lora=64, qk_nope=32, qk_rope=16, v_head=32))
        if self.ssm:
            small = dataclasses.replace(
                small, ssm=dataclasses.replace(self.ssm, state=16, headdim=16,
                                               chunk=16))
        return small


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# the assignment's four LM shapes
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# smoke-scale versions of the same four kinds
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}
