"""Qwen2-VL-72B [vlm] — M-RoPE, dynamic resolution (stubbed ViT frontend).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191].
``input_specs`` provides precomputed patch embeddings (the allowed stub).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    m_rope=True,
    m_rope_sections=(16, 24, 24),
    rope_theta=1e6,
    modality="vision",
    vision_tokens_ratio=0.25,
    long_context_variant="sliding_window",
))
