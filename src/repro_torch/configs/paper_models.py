"""The paper's own evaluation models (OPT and Llama2 families, §5).

These drive the benchmark suite (Fig 1/3-10, Tables 8/9); they are ordinary
dense decoder-only configs.
"""
from repro_torch.configs.base import ArchConfig, register


def _dense(name, L, d, H, kv, ff, vocab, **kw):
    return register(ArchConfig(
        name=name, family="dense", source="paper §5 (OPT arXiv:2205.01068 / Llama2 arXiv:2307.09288)",
        n_layers=L, d_model=d, n_heads=H, n_kv_heads=kv, d_ff=ff,
        vocab_size=vocab, long_context_variant="sliding_window", **kw))


# OPT uses a 2-matrix ReLU MLP (4h wide); our trunk is gated-SwiGLU, so the
# hidden width is the 2/3-scaled gated-equivalent keeping params at the
# advertised size.
OPT_1_3B   = _dense("opt-1.3b",  24, 2048, 32, 32,  5504, 50272)
OPT_13B    = _dense("opt-13b",   40, 5120, 40, 40, 13696, 50272)
OPT_66B    = _dense("opt-66b",   64, 9216, 72, 72, 24576, 50272)
LLAMA2_7B  = _dense("llama2-7b", 32, 4096, 32, 32, 11008, 32000)
LLAMA2_13B = _dense("llama2-13b", 40, 5120, 40, 40, 13824, 32000)
LLAMA2_70B = _dense("llama2-70b", 80, 8192, 64,  8, 28672, 32000)
