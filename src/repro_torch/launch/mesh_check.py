"""Check that a train step on a small mesh with CLEAVE shardings gives the
loss and the updated params of the unsharded single-device step (the
port's counterpart of ``scripts/check_mesh_equivalence.py``).

The reduced config is the script's (``n_layers=2, d_model=64, d_head=16,
vocab_size=256``; B 4, S 32, chunks of 16).  On the CPU the four
ranks are spawned processes joined through a ``FileStore`` in a
temporary directory, with the gloo backend.  On the card they are four
threads of this process in PyTorch's threaded process group
(``torch.testing._internal.distributed.multi_threaded_pg``), all on
``cuda:0``: NCCL refuses two ranks on one device, and gloo's processes
crash on CUDA tensors there (H100 run); the threaded group's collectives
combine the ranks' tensors in place on the card.  Tolerances are the
script's (loss within 5e-3 relative; params rtol 5e-2, atol 5e-3), and
each param leaf's relative L2 distance and the loss's relative error are
reported beside them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.mesh_check \\
        --arch llama3-8b --mesh 2x2 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

LOSS_RTOL = 5e-3
PARAM_RTOL, PARAM_ATOL = 5e-2, 5e-3
B, S, CHUNK = 4, 32, 16


def reduced_config(arch: str, **over):
    from repro_torch.configs.base import get_config
    return get_config(arch).reduced(n_layers=2, d_model=64, d_head=16,
                                    vocab_size=256, **over)


def mesh_of(dims, device_type: str):
    from repro_torch.launch import mesh as LM
    if len(dims) == 3:
        return LM.make_host_mesh(dims[1], dims[2], pod=dims[0],
                                 device_type=device_type)
    return LM.make_host_mesh(*dims, device_type=device_type)


def init_group(rank: int, world: int, store_dir: str):
    """Join the ranks' gloo group (CPU processes, torch on one thread
    each) through a FileStore in ``store_dir``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


def compare(p0, p1, m0, m1) -> dict:
    """Loss and per-leaf distances of the sharded result from the
    unsharded one."""
    import torch

    from repro_torch import tree as T
    l0, l1 = float(m0["loss"]), float(m1["loss"])
    worst_rel_l2, allclose = 0.0, True
    for a, b in zip(T.leaves(p0), T.leaves(p1)):
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        a32, b32 = a.float().cpu(), b.float().cpu()
        rel = float((a32 - b32).norm() / max(float(a32.norm()), 1e-30))
        worst_rel_l2 = max(worst_rel_l2, rel)
        allclose &= bool(torch.allclose(b32, a32, rtol=PARAM_RTOL,
                                        atol=PARAM_ATOL))
    loss_rel = abs(l0 - l1) / max(abs(l0), 1.0)
    return {"loss_single": l0, "loss_mesh": l1, "loss_rel": loss_rel,
            "params_worst_rel_l2": worst_rel_l2,
            "params_allclose": allclose,
            "ok": loss_rel < LOSS_RTOL and allclose}


def run_rank(rank, world, store_dir, arch, dims, device, out_path,
             over=None):
    """One spawned rank of the gloo group: :func:`rank_body`, and rank
    0 writes its result to ``out_path``."""
    init_group(rank, world, store_dir)
    import torch.distributed as dist
    res = rank_body(rank, world, arch, dims, device, over)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f, default=str)
    dist.barrier()
    dist.destroy_process_group()


def rank_body(rank, world, arch, dims, device, over=None):
    """One rank: the unsharded step, then the sharded one from the same
    params, optimizer state and batch.  Returns the comparison."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import specs as SP
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    from repro_torch.optim.adam import AdamState
    from repro_torch.parallel.sharding import make_rules
    dev = torch.device(device)
    cfg = reduced_config(arch, **(over or {}))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen)
    opt = adam.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.enc_dec:
        batch["encoder_feats"] = torch.randn((B, 2 * S, cfg.d_model),
                                             generator=gen, device=dev)
    chunks = dict(q_chunk=CHUNK, k_chunk=CHUNK, loss_chunk=CHUNK)
    p0, _, m0 = make_train_step(cfg, **chunks)(params, opt, batch)

    mesh = mesh_of(dims, device)
    rules = make_rules(mesh, mode="train")
    dp = SP.shard_params(params, rules)
    ospecs = SP.opt_specs(SP.param_specs(cfg, rules), rules)
    dopt = AdamState(step=opt.step,
                     mu=SP.shard_tree(opt.mu, ospecs.mu, mesh),
                     nu=SP.shard_tree(opt.nu, ospecs.nu, mesh))
    # rows on the batch axes
    db = SP.shard_tree(batch, {k: SP._divisible_spec(
        rules, v.shape, ("batch",) + (None,) * (v.dim() - 1))
        for k, v in batch.items()}, mesh)
    step = make_train_step(cfg, rules=rules, **chunks)
    p1, _, m1 = step(dp, dopt, db)
    res = compare(p0, p1, m0, m1)
    res.update(arch=arch, mesh=list(dims), device=device,
               backend=dist.get_backend())
    return res


def family_parity(arch: str, device: str = "cuda", B: int = 4,
                  S: int = 16) -> dict:
    """On this rank's 2x2 mesh, an architecture's ``.reduced()`` config
    (MoE capacity that drops no token) sharded against the single-device
    port: under the training rules the loss and every gradient, under the
    decode rules the logits of one decode step after a prefill.  Returns
    the relative errors."""
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import get_config
    from repro_torch.launch import specs as SP
    from repro_torch.models import encdec as ED
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import make_rules, use_rules
    dev = torch.device(device)
    base = get_config(arch)
    cfg = base.reduced(**({"capacity_factor": 8.0} if base.moe else {}))
    mesh = mesh_of((2, 2), device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    batch = {"tokens": tok, "labels": tok}
    if cfg.enc_dec:
        batch["encoder_feats"] = torch.randn(B, 2 * S, cfg.d_model,
                                             generator=g, device=dev)
    if cfg.modality == "vision":
        batch["vision_embeds"] = torch.randn(B, S // 4, cfg.d_model,
                                             generator=g, device=dev)

    def place(tree, rules):
        return SP.shard_tree(tree, {k: SP._divisible_spec(
            rules, v.shape, ("batch",) + (None,) * (v.dim() - 1))
            for k, v in tree.items()}, mesh)

    chunks = dict(q_chunk=8, k_chunk=8, loss_chunk=8)
    (l0, _), g0 = M.value_and_grad(cfg, params, batch, **chunks)
    rules = make_rules(mesh, "train")
    with use_rules(rules):
        (l1, _), g1 = M.value_and_grad(cfg, SP.shard_params(params, rules),
                                       place(batch, rules), **chunks)
    grad_rel = max(float((a - b.full_tensor()).norm()
                         / max(float(a.norm()), 1e-30))
                   for a, b in zip(T.leaves(g0), T.leaves(g1)))
    drules = make_rules(mesh, "decode")
    with torch.no_grad():
        if cfg.enc_dec:          # the cross K/V of the encoder frames too
            _, cache = ED.decode_cache(cfg, params, tok,
                                       batch["encoder_feats"], S)
        else:
            _, cache = M.prefill(cfg, params, {k: v for k, v in
                                               batch.items()
                                               if k != "labels"})
        want, _ = M.decode_step(cfg, params, cache, tok[:, :1])
        dcache = {n: t if n == "pos" else SP.shard_tree(
            t, SP._divisible_spec(drules, t.shape, [
                None if x == "layers" else x for x in SP.CACHE_LOGICAL[n]]),
            mesh) for n, t in cache.items()}
        with use_rules(drules):
            got, _ = M.decode_step(cfg, SP.shard_params(params, drules),
                                   dcache,
                                   place({"t": tok[:, :1]}, drules)["t"])
        got = got.full_tensor()
    return {"loss_rel": abs(float(l0) - float(l1.full_tensor()))
            / abs(float(l0)), "grad_rel": grad_rel,
            "decode_rel": float((got - want).abs().max()
                                / want.abs().max())}


def run_threaded(world: int, body):
    """``body(rank)`` in ``world`` threads joined in PyTorch's threaded
    process group; returns rank 0's result (re-raises a rank's error)."""
    import threading

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    # each thread's groups registered apart (funcol resolves them by name)
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    mt._install_threaded_pg()
    store = dist.HashStore()
    results, errors = [None] * world, []

    def run(rank):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                     store=store)
            # no destroy_process_group: uninstalling the threaded world
            # below drops every thread's groups at once
            results[rank] = body(rank)
        except BaseException as e:      # noqa: BLE001 -- re-raised below
            errors.append(e)
            mt.ProcessLocalGroup.exception_handle(e)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        mt.ProcessLocalGroup.reset()
        mt._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errors:
        raise errors[0]
    return results[0]


def check(arch: str, dims, device: str = "cuda", over=None) -> dict:
    """Run the mesh's ranks (:func:`rank_body`) and return rank 0's
    comparison: gloo processes on the CPU, threaded-group threads on the
    card."""
    world = 1
    for d in dims:
        world *= d
    if device != "cpu":
        import torch
        torch.cuda.set_device(0)
        res = run_threaded(world, lambda r: rank_body(
            r, world, arch, tuple(dims), device, over))
        res["backend"] = "threaded"
        return res
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        mp.spawn(run_rank, args=(world, tmp, arch, tuple(dims), device, out,
                                 over), nprocs=world, join=True)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--mesh", default="2x2",
                    help="2x2 (data x model) or 2x1x2 (pod x data x model)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch import resolve_device
    resolve_device(args.device)
    dims = tuple(int(x) for x in args.mesh.split("x"))
    res = check(args.arch, dims, args.device)
    print(json.dumps(res, default=str))
    print("OK: sharded step matches single-device step" if res["ok"]
          else "FAILED: sharded step differs from single-device step")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
