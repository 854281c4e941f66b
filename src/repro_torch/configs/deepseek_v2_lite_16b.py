"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, 64 routed experts top-6 + 2 shared,
first layer dense (d_ff=10944) [arXiv:2405.04434; hf].

NOTE (DESIGN.md §6): the assignment line also says "160 routed"; that figure
belongs to DeepSeek-V2 (full, 236B).  The inline spec "MoE 64e top-6" matches
the lite-16B model reproduced here.
"""

from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    vocab_size=102400,
    d_model=2048,
    n_layers=27,
    n_heads=16,
    n_kv_heads=16,            # MLA: all heads share the compressed KV
    d_ff=10944,               # the dense first layer's FFN width
    head_dim=128,
    rope_theta=10000.0,
    attn_type="mla",
    norm="rms",
    act="silu",
    mla=MLASpec(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                capacity_factor=1.25),
    dense_first_n=1,
)
