"""The FLOP and byte counts against figures worked out by hand at the
cells' shapes."""
import json

import pytest
from conftest import BENCH

from cbench import spec, yardstick
import numpy as np

from cbench.tracing import gaps, merge
from reference import deepseek_v2, rwkv6


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_deepseek_step_flops_by_hand():
    c = _cfg("deepseek-v2-236b")
    # MLA: 5120*1536 + 1536*128*192 + 5120*576 + 512*128*256 + 128*128*5120
    attn = 7_864_320 + 37_748_736 + 2_949_120 + 16_777_216 + 83_886_080
    # router 5120*160; (6 routed + 2 shared) * 3 * 5120 * 1536
    moe = 819_200 + 8 * 3 * 5120 * 1536
    head = 5120 * 102_400
    assert deepseek_v2.matmul_params(c) == attn + moe + head == 863_076_352
    # causal scores and values: 2 * B * H * S(S+1)/2 * (192 + 128)
    mixer = 2 * 4 * 128 * (1024 * 1025 / 2) * 320
    assert deepseek_v2.mixer_flops(c, 4, 1024) == mixer
    flops = yardstick.step_flops(deepseek_v2, c, 4, 1024)
    assert flops == pytest.approx(6 * 863_076_352 * 4096 + 3 * mixer)
    assert flops == pytest.approx(2.1726e13, rel=1e-4)


def test_rwkv_step_flops_by_hand():
    c = _cfg("rwkv6-7b")
    layer = 5 * 4096 ** 2 + 2 * 4096 * 64 + 2 * 4096 * 14336 + 4096 ** 2
    assert rwkv6.matmul_params(c) == 8 * layer + 4096 * 65536
    mixer = 8 * 2 * 4096 * 64 * 4 * 64 ** 2
    assert rwkv6.mixer_flops(c, 2, 4096) == mixer
    flops = yardstick.step_flops(rwkv6, c, 2, 4096)
    assert flops == pytest.approx(6 * (8 * layer + 4096 * 65536) * 8192
                                  + 3 * mixer)


@pytest.mark.parametrize("m,n,q,b,bound", [
    # deepseek's LM head forward, one loss chunk of 4 x 64 rows, bf16:
    # bytes-bound, the 1 GB weight read once per chunk
    (256, 5120, 102_400, 2, ((256 * 5120 + 5120 * 102_400) * 2
                             + 256 * 102_400 * 4) / 3.35e12),
    # a skinny bf16 product: (m n + n q) 2 + m q 4 bytes over the memory rate
    (16, 4096, 4096, 2, ((16 * 4096 + 4096 * 4096) * 2 + 16 * 4096 * 4)
     / 3.35e12),
    # the f32 router's forward at deepseek's tokens (operations-bound)
    (4096, 5120, 160, 4, max(2 * 4096 * 5120 * 160 / 989e12,
                             ((4096 * 5120 + 5120 * 160) * 4
                              + 4096 * 160 * 4) / 3.35e12)),
])
def test_gemm_least_time_by_hand(m, n, q, b, bound):
    assert yardstick.gemm_least_s(m, n, q, b) == pytest.approx(bound)


def test_busy_union_and_idle_gaps():
    bs, be = merge(np.array([5.0, 0, 1, 8, 1.5]), np.array([6.0, 2, 3, 9, 2]))
    assert bs.tolist() == [0, 5, 8] and be.tolist() == [3, 6, 9]
    gs, ge = gaps(bs, be, 0.0, 10.0)
    assert gs.tolist() == [3, 6, 9] and ge.tolist() == [5, 8, 10]


def test_family_found_by_the_config_name():
    assert spec.family(_cfg("rwkv6-7b")) is rwkv6
