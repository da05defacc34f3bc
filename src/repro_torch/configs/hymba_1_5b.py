"""Hymba-1.5B [hybrid] — parallel attention + Mamba heads, meta tokens.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16
[arXiv:2411.13676].
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    ssm=True,
    ssm_state=16,
    hybrid_parallel=True,
    n_meta_tokens=128,
    sliding_window=0,
    long_context_variant="native",      # SSM branch carries long context;
    long_context_window=2048,           # attention branch uses SWA (as in paper)
))
