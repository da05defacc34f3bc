"""GEMM-DAG extraction (§3.2).

The paper traces runtime GEMM calls (cublas hooks) into a DAG whose nodes are
GEMMs and whose edges are memory dependencies, then schedules level-by-level.
Here the trace is derived symbolically from the ``ArchConfig`` (equivalent
information, no framework hooks needed): for a given (batch, seq) we emit
every forward GEMM with its (m, n, q) and DAG level, then mirror each forward
GEMM into its two backward GEMMs (dA = dO·Bᵀ at the same shapes transposed,
dW = Aᵀ·dO).  GEMMs sharing a level are mutually independent (Table 6).

Non-GEMM ops (LayerNorm/softmax/activations/optimizer) are deliberately
excluded: they run on the PS host (<1% of FLOPs, Table 1/2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.cost_model import GEMM


@dataclass
class GemmDag:
    gemms: List[GEMM]
    n_levels: int
    batch: int
    seq: int

    def total_flops(self) -> float:
        return sum(g.flops * g.count for g in self.gemms)

    def total_in_bytes(self) -> float:
        return sum(g.in_bytes * g.count for g in self.gemms)

    def total_out_bytes(self) -> float:
        return sum(g.out_bytes * g.count for g in self.gemms)

    def levels(self):
        out = {}
        for g in self.gemms:
            out.setdefault(g.level, []).append(g)
        return [out[k] for k in sorted(out)]

    def unique_shapes(self):
        seen = {}
        for g in self.gemms:
            seen.setdefault((g.m, g.n, g.q, g.b), 0)
            seen[(g.m, g.n, g.q, g.b)] += g.count
        return seen

    def level_order(self) -> List[List[int]]:
        """Node indices grouped by DAG level, levels ascending."""
        out = {}
        for i, g in enumerate(self.gemms):
            out.setdefault(g.level, []).append(i)
        return [out[k] for k in sorted(out)]

    def dependencies(self) -> List[List[int]]:
        """Per-node producer indices for dataflow dispatch.

        The symbolic trace stores levels, not pointer-chased edges, so this
        is the conservative within-layer reconstruction.  Forward: a node
        at level l depends on the level-(l-1) nodes of its own layer (the
        GEMMs whose outputs feed its operands through PS-side norms /
        softmax / activations), widening to the whole previous level at
        layer boundaries.  Backward: ``build_dag`` places dA at level
        ``blv`` and dW at ``blv+1``, but both mirrors consume the *same*
        cotangent dO — produced by the dA two backward levels up (the dW
        sibling feeds the optimizer, not the chain rule), and dW's other
        operand is the stashed forward activation (long complete).  So dA
        at level L draws from level L-2 and dW at L from L-3, clamped to
        the last forward level at the fwd->bwd turn; this keeps the two
        mirrors of one GEMM mutually independent instead of falsely
        serializing the whole backward pass.  GEMMs sharing a level stay
        mutually independent (Table 6); false extra edges within a layer
        are possible but never a missed true edge, so dataflow execution
        ordered by these deps is always level-consistent.
        """
        by_level = {}
        for i, g in enumerate(self.gemms):
            by_level.setdefault(g.level, []).append(i)
        order = sorted(by_level)
        first_bwd = min(
            (g.level for g in self.gemms
             if g.name.endswith((".dA", ".dW"))), default=None)
        deps: List[List[int]] = [[] for _ in self.gemms]
        for li in range(1, len(order)):
            for i in by_level[order[li]]:
                g = self.gemms[i]
                if first_bwd is not None and g.level >= first_bwd:
                    src = g.level - (2 if g.name.endswith(".dA") else 3)
                    if src < first_bwd:
                        src = first_bwd - 1       # the fwd->bwd turn
                    prev = by_level.get(src, [])
                else:
                    prev = by_level[order[li - 1]]
                same = [j for j in prev
                        if self.gemms[j].layer == g.layer]
                deps[i] = same if same else list(prev)
        return deps


def _bytes(cfg) -> int:
    return 2 if "16" in cfg.dtype else 4


def layer_forward_gemms(cfg, batch: int, seq: int, layer: int,
                        level0: int, b: int,
                        attention_scores: str = "devices") -> tuple:
    """Forward GEMMs of one layer starting at DAG level `level0`.
    Returns (gemms, next_level).

    attention_scores="ps" keeps the per-(batch,head) s×s score/AV GEMMs on
    the PS host (alongside the softmax they sandwich): their outputs are
    large relative to their FLOPs (output-heavy, the one GEMM class that
    *mis*-matches uplink asymmetry), which is also how the paper's Table 8
    batch-time arithmetic accounts them."""
    T = batch * seq
    d = cfg.d_model
    g: List[GEMM] = []
    lv = level0

    def add(name, m, n, q, count=1):
        g.append(GEMM(m=m, n=n, q=q, b=b, name=f"L{layer}.{name}",
                      level=lv, layer=layer, count=count))

    if cfg.rwkv:
        # time-mix projections (r,k,v,g,w-lora) are independent
        for nm in ("r", "k", "v", "g"):
            add(f"tm.{nm}", T, d, d)
        lv += 1
        add("tm.out", T, d, d)
        lv += 1
        # channel mix
        add("cm.key", T, d, cfg.d_ff)
        lv += 1
        add("cm.val", T, cfg.d_ff, d)
        add("cm.recv", T, d, d)
        lv += 1
        return g, lv

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla:
        r, rd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_dim
        if cfg.q_lora_rank:
            add("attn.q_down", T, d, cfg.q_lora_rank)
            add("attn.kv_down", T, d, r + rd)
            lv += 1
            add("attn.q_up", T, cfg.q_lora_rank, H * (hd + rd))
        else:
            add("attn.q", T, d, H * (hd + rd))
            add("attn.kv_down", T, d, r + rd)
            lv += 1
        add("attn.k_up", T, r, H * hd)
        add("attn.v_up", T, r, H * vd)
        lv += 1
        if attention_scores == "devices":
            add("attn.qk", seq, hd + rd, seq, count=batch * H)
            lv += 1
            add("attn.av", seq, seq, vd, count=batch * H)
            lv += 1
        add("attn.out", T, H * vd, d)
        lv += 1
    elif not cfg.attn_free:
        add("attn.q", T, d, H * hd)
        add("attn.k", T, d, K * hd)
        add("attn.v", T, d, K * hd)
        lv += 1
        if attention_scores == "devices":
            s_eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
            add("attn.qk", seq, hd, s_eff, count=batch * H)
            lv += 1
            add("attn.av", seq, s_eff, hd, count=batch * H)
            lv += 1
        add("attn.out", T, H * hd, d)
        lv += 1

    if cfg.hybrid_parallel or (cfg.ssm and not cfg.rwkv):
        di = cfg.d_inner
        add("ssm.in", T, d, 2 * di)
        lv += 1
        add("ssm.bcdt", T, di, 2 * cfg.ssm_state + max(1, d // 16))
        lv += 1
        add("ssm.out", T, di, d)
        lv += 1

    if cfg.moe:
        E, k, ff = cfg.n_experts, cfg.moe_top_k, cfg.moe_d_ff
        cap = int(T * k * cfg.capacity_factor / E) + 1
        add("moe.router", T, d, E)
        lv += 1
        add("moe.gate", cap, d, ff, count=E)
        add("moe.up", cap, d, ff, count=E)
        if cfg.n_shared_experts:
            add("moe.shared_gate", T, d, cfg.n_shared_experts * ff)
            add("moe.shared_up", T, d, cfg.n_shared_experts * ff)
        lv += 1
        add("moe.down", cap, ff, d, count=E)
        if cfg.n_shared_experts:
            add("moe.shared_down", T, cfg.n_shared_experts * ff, d)
        lv += 1
    else:
        add("mlp.gate", T, d, cfg.d_ff)
        add("mlp.up", T, d, cfg.d_ff)
        lv += 1
        add("mlp.down", T, cfg.d_ff, d)
        lv += 1
    return g, lv


def build_dag(cfg, batch: int, seq: int, *, backward: bool = True,
              lm_head: bool = True,
              attention_scores: str = "devices") -> GemmDag:
    b = _bytes(cfg)
    gemms: List[GEMM] = []
    lv = 0
    n_layers = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    for layer in range(n_layers):
        g, lv = layer_forward_gemms(cfg, batch, seq, layer, lv, b,
                                    attention_scores)
        gemms.extend(g)
        if cfg.enc_dec and layer >= cfg.n_enc_layers:
            # decoder cross-attention projections + attention
            T = batch * seq
            d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            enc_T = batch * seq * cfg.enc_seq_ratio
            gemms.append(GEMM(m=T, n=d, q=H * hd, b=b, level=lv,
                              layer=layer, name=f"L{layer}.cross.q"))
            gemms.append(GEMM(m=enc_T, n=d, q=2 * K * hd, b=b, level=lv,
                              layer=layer, name=f"L{layer}.cross.kv"))
            lv += 1
            gemms.append(GEMM(m=seq, n=hd, q=seq * cfg.enc_seq_ratio, b=b,
                              level=lv, layer=layer, count=batch * H,
                              name=f"L{layer}.cross.qk"))
            lv += 1
            gemms.append(GEMM(m=seq, n=seq * cfg.enc_seq_ratio, q=hd, b=b,
                              level=lv, layer=layer, count=batch * H,
                              name=f"L{layer}.cross.av"))
            lv += 1
    if lm_head:
        gemms.append(GEMM(m=batch * seq, n=cfg.d_model, q=cfg.vocab_size,
                          b=b, level=lv, layer=n_layers, name="lm_head"))
        lv += 1
    if backward:
        fwd = list(gemms)
        max_lv = lv
        for g in fwd:
            blv = max_lv + (max_lv - 1 - g.level) * 2
            # dA = dO (m,q) @ B^T (q,n)  and  dW = A^T (n,m) @ dO (m,q)
            gemms.append(GEMM(m=g.m, n=g.q, q=g.n, b=g.b, level=blv,
                              layer=g.layer, count=g.count,
                              name=g.name + ".dA"))
            gemms.append(GEMM(m=g.n, n=g.m, q=g.q, b=g.b, level=blv + 1,
                              layer=g.layer, count=g.count,
                              name=g.name + ".dW"))
        lv = max_lv + max_lv * 2
    return GemmDag(gemms=gemms, n_levels=lv, batch=batch, seq=seq)
