"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*1536 = 3072, headdim=64 -> 48 SSD heads; no attention, no MLP
(Mamba2 blocks only) — `long_500k` runs on this arch (O(1)-state decode).
"""

from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    vocab_size=50280,
    d_model=1536,
    n_layers=48,
    n_heads=48,               # informational: SSD heads = d_inner/headdim
    n_kv_heads=48,
    d_ff=0,                   # attn-free, MLP-free family
    tie_embeddings=True,
    norm="rms",
    ssm=SSMSpec(state=128, headdim=64, conv_width=4, expand=2, chunk=128),
)
