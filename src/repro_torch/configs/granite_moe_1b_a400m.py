"""Granite-3.0-1B-A400M [moe] — 32 experts top-8, GQA kv=8.

24L d_model=1024 16H d_ff(per-expert)=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=True,
    n_experts=32,
    n_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
    long_context_variant="sliding_window",
))
