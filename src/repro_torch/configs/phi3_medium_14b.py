"""Phi-3-medium-14B [dense] — RoPE, SwiGLU, GQA kv=10 [arXiv:2404.14219]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=1e4,
    long_context_variant="sliding_window",
))
