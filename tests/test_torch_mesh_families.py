"""Every other registered family on the mesh: one spawned group of four
gloo ranks (torch on one thread in each) holds, on a 2x2 (data x model)
mesh with the training rules, each family's loss and every gradient to
the single-device port's, and, under the decode rules, the first decode
step's logits after a prefill.  The sharded forms differ by family: the
attention families shard heads over 'model' (qwen2-vl's M-RoPE,
seamless's encoder and cross-attention, phi3's and qwen's head counts),
MLA's latent projections shard like any projection and its absorbed
decode runs on each rank's batch rows, and the RWKV and SSM recurrences
run on each rank's batch rows (``spmd.on_batch_rows``)
(``launch.mesh_check.family_parity``).  llama3-8b and
granite-moe-1b-a400m are held by tests/test_torch_mesh_spmd.py."""
from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
FAMILIES = ("deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b", "qwen2-vl-72b",
            "seamless-m4t-medium", "qwen3-32b", "phi3-medium-14b",
            "qwen1.5-32b")
STRICT = 1e-5


def _rank(rank, world, store_dir, out_path):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.launch import mesh_check as MC
    MC.init_group(rank, world, store_dir)
    res = {arch: MC.family_parity(arch, "cpu") for arch in FAMILIES}
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("families")
    out = tmp / "result.json"
    mp.spawn(_rank, args=(WORLD, str(tmp), str(out)), nprocs=WORLD,
             join=True)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sharded_matches_single_device(families, arch):
    """Loss within 1e-5 relative, every gradient leaf within 1e-5 relative
    L2, and the decode step's logits within 1e-5 of their largest entry
    (f32, the reduced config)."""
    r = families[arch]
    assert r["loss_rel"] <= STRICT, r
    assert r["grad_rel"] <= STRICT, r
    assert r["decode_rel"] <= STRICT, r
