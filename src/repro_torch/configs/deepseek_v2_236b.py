"""DeepSeek-V2-236B [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff(dense-equiv)=1536-per-expert vocab=102400
[arXiv:2405.04434].  Deviation noted in DESIGN.md: paper model's first layer
is dense-MLP; we make all 60 layers MoE for uniform scan-over-layers.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=12288,               # shared-expert/dense equivalent width
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    long_context_variant="sliding_window",  # MLA cache is compact but still O(S)
))
