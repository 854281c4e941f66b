"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024
vocab=50304, 64 experts top-8 [arXiv:2409.02060; hf]."""

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    vocab_size=50304,
    d_model=2048,
    n_layers=16,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    head_dim=128,
    rope_theta=10000.0,
    attn_type="gqa",
    norm="rms",
    act="silu",
    moe=MoESpec(num_experts=64, top_k=8, d_expert=1024, num_shared=0,
                capacity_factor=1.25),
)
