"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].

The audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings [B, S, d_model]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    vocab_size=256206,
    d_model=1024,
    n_layers=12,              # decoder depth
    enc_layers=12,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    head_dim=64,
    norm="ln",
    act="gelu",
)
