"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    vocab_size=49152,
    d_model=960,
    n_layers=32,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    head_dim=64,
    rope_theta=10000.0,
    tie_embeddings=True,
    attn_type="gqa",
    norm="rms",
    act="silu",
    remat_policy="dots",   # fits (8.4 GB live) and cuts all terms 15-20%
)
