"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; vision frontend is a
STUB (input_specs supplies precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    vocab_size=128256,
    d_model=4096,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    head_dim=128,
    rope_theta=500000.0,
    attn_type="gqa",
    norm="rms",
    act="silu",
    cross_attn_every=5,
    frontend_tokens=1601,     # 1 CLS + 40x40 patches, one tile (stub)
)
