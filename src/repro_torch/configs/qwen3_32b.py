"""Qwen3-32B [dense] — qk-norm, GQA kv=8 [hf:Qwen/Qwen3-8B family card]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (family card, 32B scale-up)",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    long_context_variant="sliding_window",
))
