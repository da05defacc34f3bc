"""The plain reference's pieces against their definitions."""
import math

import torch

from reference import deepseek_v2
from reference.common import make_dot
from reference.rwkv6 import wkv


def test_chunked_wkv_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 2, 200, 2, 8
    r, k, v = (torch.randn(B, S, H, hd, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, hd, generator=g) - 1))
    u = torch.randn(H, hd, generator=g) * 0.1
    s = torch.zeros(B, H, hd, hd)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    want = torch.stack(ys, 1)
    for chunk in (16, 64):
        assert torch.allclose(wkv(r, k, v, w, u, chunk=chunk), want,
                              atol=1e-4, rtol=1e-4)


def test_experts_keep_the_first_tokens_up_to_capacity():
    """With every token routed to expert 0 first, only the first C of
    them reach it: the output of the later ones lacks expert 0."""
    torch.manual_seed(0)
    cfg = {"hidden_size": 8, "num_attention_heads": 1, "qk_nope_head_dim": 4,
           "qk_rope_head_dim": 2, "v_head_dim": 4, "kv_lora_rank": 4,
           "q_lora_rank": 4, "n_routed_experts": 4, "num_experts_per_tok": 1,
           "moe_intermediate_size": 4, "n_shared_experts": 1,
           "vocab_size": 16, "num_hidden_layers": 1, "capacity_factor": 1.0,
           "router_aux_loss_coef": 0.0}
    router = torch.zeros(8, 4)
    router[:, 0] = 10.0
    p = {"router": router,
         "w_gate": torch.randn(4, 8, 4), "w_up": torch.randn(4, 8, 4),
         "w_down": torch.randn(4, 4, 8),
         "shared": {"w_gate": torch.zeros(8, 4), "w_up": torch.zeros(8, 4),
                    "w_down": torch.zeros(4, 8)}}
    x = torch.ones(1, 16, 8)
    out, _ = deepseek_v2.moe(cfg, p, x, make_dot("bf16"))
    C = max(math.ceil(16 * 1 * 1.0 / 4), 4)
    assert (out[0, :C].abs().sum(-1) > 0).all()
    assert (out[0, C:] == 0).all()


def test_the_port_departures_are_what_the_reference_computes():
    """The configuration keeps the published routing and epsilon at its
    top level and the port's under ``port_runs``: the reference follows
    the port's, and refuses a routing that it does not compute."""
    import json
    from conftest import ROOT
    cfg = json.loads((ROOT / "cleave_bench" / "configs"
                      / "deepseek-v2-236b.json").read_text())
    assert cfg["topk_method"] == "group_limited_greedy"
    assert cfg["rms_norm_eps"] == 1e-6
    run = deepseek_v2.as_run(cfg)
    assert run["topk_method"] == "greedy" and run["rms_norm_eps"] == 1e-5
    published = {k: v for k, v in cfg.items() if k != "port_runs"}
    try:
        deepseek_v2.as_run(published)
    except NotImplementedError as err:
        assert "group_limited_greedy" in str(err)
    else:
        raise AssertionError("a published routing passed")
