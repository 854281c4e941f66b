"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    vocab_size=32768,
    d_model=12288,
    n_layers=88,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    head_dim=128,
    rope_theta=1000000.0,
    attn_type="gqa",
    norm="rms",
    act="silu",
)
