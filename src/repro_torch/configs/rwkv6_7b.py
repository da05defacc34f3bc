"""RWKV-6 "Finch" 7B [ssm] — attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536 [arXiv:2404.05892].
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=14336,
    vocab_size=65536,
    attn_free=True,
    rwkv=True,
    rwkv_head_dim=64,
    long_context_variant="native",   # O(1) recurrent state
))
