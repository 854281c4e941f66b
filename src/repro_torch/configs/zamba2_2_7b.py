"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention block every
6 layers (weights reused, fed concat(hidden, embed0), Zamba2-style)
[arXiv:2411.15242; hf].

At the long_500k shape the shared attention runs a 4096-token sliding
window so the hybrid stays sub-quadratic (the Mamba2 backbone is the
long-range path) — DESIGN.md §6.
"""

from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    vocab_size=32000,
    d_model=2560,
    n_layers=54,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    head_dim=80,
    rope_theta=10000.0,
    norm="rms",
    act="silu",
    ssm=SSMSpec(state=64, headdim=64, conv_width=4, expand=2, chunk=128),
    shared_attn_every=6,
    sliding_window=4096,
)
