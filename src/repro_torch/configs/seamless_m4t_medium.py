"""SeamlessM4T-medium [audio] — enc-dec transformer backbone.

12L (each side) d_model=1024 16H d_ff=4096 vocab=256206 [arXiv:2308.11596].
Mel-spectrogram + conv feature extractor is stubbed: ``input_specs`` hands the
encoder precomputed frame embeddings of shape (B, S_enc, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    enc_dec=True,
    modality="audio",
    enc_seq_ratio=2,
    long_context_variant="sliding_window",
))
