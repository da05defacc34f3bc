"""Qwen1.5-32B [dense] — QKV bias, GQA kv=40 (i.e. MHA-style kv=heads).

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064 [hf:Qwen/Qwen1.5-0.5B].
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B (family card, 32B scale-up)",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    long_context_variant="sliding_window",
))
