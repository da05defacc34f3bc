"""Llama-3-8B [dense] — GQA kv=8, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    long_context_variant="sliding_window",
))
