"""Multi-PS sharded training with the port (the counterpart of
``examples/train_multi_ps.py``): K parameter-server islands under the
sharded DiLoCo outer loop.

The fleet is partitioned into ``--n-ps`` flops-balanced islands
(``api.ShardedFleet``); each island runs H local AdamW inner steps on its
own synthetic data shard, every projection GEMM fleet-executed through the
island's own ``TorchCleaveRuntime`` on the band GEMM kernel; at each round
boundary the K servers reduce the drifted replicas and apply Nesterov
momentum to the pseudo-gradient (``optim.diloco.outer_step_sharded``),
moving 2 (K-1) x param-volume across the PS-to-PS links instead of H
gradient volumes.  ``--fail-ps`` kills one server mid-run: its island is
evicted and its devices fold into the survivors with ids preserved.  The
islands' state lives on ``--device`` (the card, one island after the
other).

Run (CUDA card):  PYTHONPATH=src python examples_torch/train_multi_ps.py
Run (CPU):        PYTHONPATH=src python examples_torch/train_multi_ps.py --device cpu
Island failure mid-round:
    PYTHONPATH=src python examples_torch/train_multi_ps.py --fail-ps 1
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.optim.diloco import DiLoCoConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--n-ps", type=int, default=2,
                    help="parameter-server islands (None-like 0 = "
                         "auto-size from the multi_ps_plan envelope)")
    ap.add_argument("--inner-steps", type=int, default=2,
                    help="H: local AdamW steps per DiLoCo round")
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--fail-ps", type=int, default=None,
                    help="kill this PS island at the midpoint step")
    ap.add_argument("--device", default="cuda",
                    help="where the islands' state and the kernels live "
                         "(cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama3-8b").reduced()
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=2,
                              total_steps=max(args.steps, 10))
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)

    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(args.devices,
                                                         seed=0),
                            device=dev)
    sess = rt.train_session(
        opt_cfg, n_ps=args.n_ps or None,
        diloco=DiLoCoConfig(inner_steps=args.inner_steps,
                            outer_lr=args.outer_lr),
        q_chunk=16, k_chunk=16, loss_chunk=16)
    print(f"sharded fleet: {sess.sharded!r}")

    # one synthetic data shard per island (data parallelism across PSs)
    shards = [SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     global_batch=args.batch, seed=7 * k))
              for k in range(sess.n_islands)]
    state = sess.init(params, opt)
    fail_at = args.steps // 2 if args.fail_ps is not None else None
    reports = []
    for step in range(args.steps):
        batches = [{k: torch.as_tensor(v, device=dev)
                    for k, v in d.batch(step).items()}
                   for d in shards[:sess.n_islands]]
        kw = {"fail_ps": args.fail_ps} if step == fail_at else {}
        state, metrics = sess.step(state, batches, **kw)
        reports.append(metrics["multi_ps"])
        print(metrics["multi_ps"].log_line())

    print(f"done: {state.inner_step} inner steps, {state.round} outer "
          f"rounds, {sess.n_islands} island(s) alive, "
          f"final mean loss {metrics['loss']:.4f}")
    return {"reports": reports, "inner_steps": state.inner_step,
            "rounds": state.round, "n_islands": sess.n_islands,
            "loss": metrics["loss"]}


if __name__ == "__main__":
    main()
