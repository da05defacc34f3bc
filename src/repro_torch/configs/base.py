"""Architecture configuration system.

Every assigned architecture gets one ``ArchConfig`` in its own module under
``repro_torch.configs``; the registry maps ``--arch <id>`` to the config.  A config
fully determines the model (layer plan, attention flavor, MoE/SSM settings)
and its reduced smoke-test variant.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation (arXiv / HF card)

    # trunk ---------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: Optional[int] = None     # default: d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention flavor ------------------------------------------------------
    attn_free: bool = False          # rwkv: no attention at all
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # qwen3
    rope_theta: float = 1e4
    m_rope: bool = False             # qwen2-vl multimodal rotary
    m_rope_sections: tuple = (16, 24, 24)   # halves of d_head/2
    sliding_window: int = 0          # 0 = full attention (training/prefill)
    long_context_variant: str = ""   # "" | "sliding_window" | "native"
    long_context_window: int = 8192  # ring-cache length for 500k decode

    # MLA (DeepSeek-V2) ------------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 = dense q projection
    rope_head_dim: int = 64          # decoupled RoPE key dim
    v_head_dim: int = 0              # default d_head

    # MoE ---------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / RWKV / hybrid ------------------------------------------------------
    ssm: bool = False                # mamba-style branch
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv: bool = False               # RWKV-6 time-mix/channel-mix
    rwkv_head_dim: int = 64
    hybrid_parallel: bool = False    # hymba: attn + ssm heads in parallel
    n_meta_tokens: int = 0           # hymba learned prefix

    # encoder-decoder (audio) ----------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_ratio: int = 2           # encoder frames per decoder token (stub)

    # modality stubs ------------------------------------------------------------
    modality: str = "text"           # text | vision | audio
    vision_tokens_ratio: float = 0.25  # fraction of sequence that is patches

    # numerics -------------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # ----------------------------------------------------------------- helpers --
    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads

    @property
    def v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def n_params(self) -> int:
        """Analytic parameter count (embedding + per-layer blocks + head)."""
        d, hd, vd = self.d_model, self.head_dim, self.v_dim
        p = self.vocab_size * d                     # embed
        if not self.tie_embeddings:
            p += self.vocab_size * d                # lm head
        per_layer = 0
        if self.rwkv:
            # time-mix r,k,v,g,w,o projections (~6 d^2) + channel-mix (2*d*d_ff)
            per_layer += 6 * d * d + 2 * d * self.d_ff
        else:
            if not self.attn_free and not self.hybrid_parallel:
                per_layer += self._attn_params()
            if self.hybrid_parallel:
                per_layer += self._attn_params() + self._ssm_params()
            if self.ssm and not self.hybrid_parallel:
                per_layer += self._ssm_params()
            if self.moe:
                per_layer += self.n_experts * 3 * d * self.moe_d_ff
                per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
                per_layer += d * self.n_experts    # router
            else:
                per_layer += 3 * d * self.d_ff     # swiglu
        p += self.n_layers * per_layer
        if self.enc_dec:
            enc_layer = self._attn_params() + 3 * d * self.d_ff
            cross = 2 * (d * self.n_heads * hd + d * self.n_kv_heads * hd)
            p += self.n_enc_layers * enc_layer + self.n_layers * cross
        return p

    def _attn_params(self) -> int:
        d, hd, vd = self.d_model, self.head_dim, self.v_dim
        if self.mla:
            qp = (d * self.q_lora_rank
                  + self.q_lora_rank * self.n_heads * (hd + self.rope_head_dim)
                  ) if self.q_lora_rank else d * self.n_heads * (hd + self.rope_head_dim)
            kvp = d * (self.kv_lora_rank + self.rope_head_dim)
            kvp += self.kv_lora_rank * self.n_heads * (hd + vd)
            op = self.n_heads * vd * d
            return qp + kvp + op
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        return 2 * d * di + di * (2 * n + 2) + di * d

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        total = self.n_params()
        routed = self.n_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        active_routed = self.n_layers * self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        return total - routed + active_routed

    def reduced(self, **over) -> "ArchConfig":
        """Smoke-test variant: same family/flavor, tiny dims (spec: ≤2 layers,
        d_model ≤ 512, ≤4 experts)."""
        d = min(self.d_model, 256)
        hd = 32
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, self.n_kv_heads))
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        kw = dict(
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=hd,
            d_ff=min(self.d_ff, 4 * d),
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            param_dtype="float32",
        )
        if self.m_rope:
            half = hd // 2
            s1 = half // 4
            kw.update(m_rope_sections=(s1, (half - s1) // 2,
                                       half - s1 - (half - s1) // 2))
        if self.mla:
            kw.update(kv_lora_rank=64, q_lora_rank=(48 if self.q_lora_rank else 0),
                      rope_head_dim=16, v_head_dim=(hd if self.v_head_dim else 0))
        if self.moe:
            kw.update(n_experts=4, moe_top_k=min(2, self.moe_top_k),
                      n_shared_experts=min(1, self.n_shared_experts),
                      moe_d_ff=64)
        if self.ssm or self.hybrid_parallel:
            kw.update(ssm_state=8)
        if self.rwkv:
            kw.update(rwkv_head_dim=16)
        if self.enc_dec:
            kw.update(n_enc_layers=2)
        if self.n_meta_tokens:
            kw.update(n_meta_tokens=8)
        kw.update(over)
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------------ registry --
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

_MODULES = [
    "qwen1_5_32b", "hymba_1_5b", "phi3_medium_14b", "deepseek_v2_236b",
    "qwen2_vl_72b", "llama3_8b", "qwen3_32b", "seamless_m4t_medium",
    "rwkv6_7b", "granite_moe_1b_a400m", "paper_models",
]


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True


# ------------------------------------------------------------- input shapes --
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
