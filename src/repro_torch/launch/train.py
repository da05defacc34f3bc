"""End-to-end training driver of the port (port of
``src/repro/launch/train.py`` without the mesh).

``--backend torch`` runs the monolithic step (``launch.steps``, plain
``torch.matmul`` projections); ``--backend fleet`` runs every step
PS-centrically through :class:`~repro_torch.api.TorchCleaveRuntime`: each
projection GEMM -- forward and backward -- is planned, dispatched to the
band GEMM kernel, Freivalds-verified and (under ``--fail-step``)
churn-recovered on a simulated edge fleet, while the PS (the card) hosts
the embeddings, norms, attention (the flash-attention kernel), the loss
and AdamW.  Runs on the card unless ``--device cpu``.

Usage (from the repository root)::

  PYTHONPATH=src python -m repro_torch.launch.train --layers 4 \\
      --backend fleet --steps 3 --fail-step 1 --fail-ids 3
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --layers 2 \\
      --d-model 64 --vocab 256 --steps 2 --batch 2 --seq 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
      --batch 2 --seq 16 --device cpu --backend fleet --ckpt-dir DIR \\
      --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --layers 4 --backend fleet --steps 3 --fail-step 1 --fail-ids 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --layers 4 --backend fleet --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-v2-236b --layers 1 --backend fleet --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-vl-72b --layers 3 --backend fleet --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-medium --backend fleet --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch hymba-1.5b --backend fleet --steps 3

For RWKV-6, as in the reference, only the LM head's GEMMs reach the fleet;
the time mix (the WKV kernel) and the channel mix run on the PS.  For MoE
the router's GEMMs reach the fleet beside the attention projections and
the LM head; the routed experts run on the PS, on the batched block GEMM
kernel.  For MLA (deepseek-v2-236b) the latent and up-projections reach
the fleet too; the attention runs on the flash kernel at q/k 192, v 128.
As the reference's driver does, qwen2-vl-72b's batches carry seq // 4
precomputed patch embeddings a row (the stubbed vision frontend), and
seamless-m4t-medium's 2 * seq precomputed audio frames
(``data.pipeline.modality_stubs``); the encoder's projections reach the
fleet too, and its layers' recompute in the backward with them.  For the
hybrid (hymba-1.5b) the attention projections, the MLP and the LM head
reach the fleet; the SSM heads' projections and scan run on the PS, as
the reference's ``@`` keeps them there.
Each step updates the params and the optimizer moments in place, as the
reference's driver donates them (``donate_argnums=(0, 1)``): one
full-width deepseek-v2-236b layer would not fit the card with a second
copy.  ``--ckpt-dir DIR`` saves ``{"params", "opt"}`` with the step's
loss at every step that ``--ckpt-every`` divides, from step 0, as the
reference's driver does (``checkpointing.checkpoint.CheckpointManager``,
the newest 3 kept).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save params and optimizer state here every "
                         "--ckpt-every steps (npz, the reference's keys)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the PS state and the kernels run")
    ap.add_argument("--backend", default="torch", choices=("torch", "fleet"),
                    help="torch: monolithic step; fleet: every projection "
                         "GEMM executes on a simulated edge fleet via the "
                         "TorchCleaveRuntime session (PS-centric, §3.2)")
    ap.add_argument("--fleet-devices", type=int, default=16,
                    help="fleet size for --backend fleet")
    ap.add_argument("--fleet-exec", default="torch",
                    choices=("torch", "numpy"),
                    help="fleet executor (torch: the band GEMM kernel on "
                         "--device; numpy: the float64 host stand-in)")
    ap.add_argument("--fail-step", type=int, default=None,
                    help="inject a device failure during this step "
                         "(--backend fleet)")
    ap.add_argument("--fail-ids", default="",
                    help="comma-separated device ids for --fail-step")
    ap.add_argument("--fail-at-gemm", type=int, default=0,
                    help="GEMM index within --fail-step at which the "
                         "failure strikes")
    ap.add_argument("--edge-plan", type=int, default=0, metavar="N",
                    help="before training, plan this config's batch over an "
                         "N-device edge fleet and print the projected "
                         "batch time")
    ap.add_argument("--edge-accounting", default="broadcast",
                    choices=("unicast", "broadcast"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch import tree as T
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           modality_stubs)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adam

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
        over["d_ff"] = 4 * args.d_model
    if args.vocab:
        over["vocab_size"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)

    from repro_torch.api import Fleet, TorchCleaveRuntime
    if args.edge_plan > 0:
        rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(args.edge_plan,
                                                             seed=args.seed),
                                accounting=args.edge_accounting, device=dev)
        rep = rt.plan(batch=args.batch, seq=args.seq)
        print(f"edge plan ({args.edge_plan} devices, "
              f"{rep.accounting}): batch_time={rep.batch_time:.1f}s "
              f"comm/dev={rep.per_device_comm / 1e6:.0f}MB "
              f"mem/dev={rep.per_device_mem / 1e6:.0f}MB "
              f"solved {rep.cache_misses} shapes in {rep.solve_time:.2f}s")

    opt_cfg = adam.AdamConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                              total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen)
    opt_state = adam.init(params, opt_cfg)
    n_params = sum(x.numel() for x in T.leaves(params))
    print(f"arch={cfg.name} params={n_params:,} vocab={cfg.vocab_size} "
          f"layers={cfg.n_layers} d={cfg.d_model} device={dev}")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch,
                                  seed=args.seed))
    fleet_session = None
    fail_ids = [int(i) for i in args.fail_ids.split(",") if i.strip()]
    if args.fail_step is not None and not fail_ids:
        raise SystemExit("--fail-step needs --fail-ids (comma-separated "
                         "device ids to fail)")
    if (args.fail_step is not None or fail_ids) \
            and args.backend != "fleet":
        raise SystemExit("--fail-step/--fail-ids inject fleet device "
                         "failures; pass --backend fleet")
    if args.fail_step is not None and args.fail_step >= args.steps:
        raise SystemExit(f"--fail-step {args.fail_step} never runs: the "
                         f"run has only {args.steps} step(s)")
    if args.backend == "fleet":
        rt = TorchCleaveRuntime(arch=cfg,
                                fleet=Fleet.sample(args.fleet_devices,
                                                   seed=args.seed),
                                accounting=args.edge_accounting, device=dev)
        fleet_session = rt.train_session(
            opt_cfg, backend=args.fleet_exec, q_chunk=64, k_chunk=64,
            loss_chunk=64)
        print(f"fleet backend: {len(rt.fleet)} devices "
              f"({args.fleet_exec} executor), accounting="
              f"{args.edge_accounting}")
        step_fn = None
    else:
        step_fn = make_train_step(cfg, opt_cfg, q_chunk=64, k_chunk=64,
                                  loss_chunk=64, donate=True)

    mgr = None
    if args.ckpt_dir:
        from repro_torch.checkpointing.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)

    history = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        raw = data.batch(step)
        raw.update(modality_stubs(cfg, args.batch, args.seq, step,
                                  args.seed))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        if fleet_session is not None:
            fid = fail_ids if step == args.fail_step else ()
            params, opt_state, metrics = fleet_session.step(
                params, opt_state, batch, fail_ids=fid,
                fail_at_gemm=args.fail_at_gemm, donate=True)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        row = {"step": step, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"])}
        if fleet_session is not None:
            rep = metrics["fleet"]
            row.update(fleet_gemms=rep.n_gemms, fleet_tasks=rep.n_tasks,
                       fleet_recovered=rep.n_recovered,
                       fleet_verified=rep.verified,
                       fleet_exec_time=rep.fleet_exec_time,
                       fleet_predicted_makespan=rep.predicted_makespan,
                       fleet_cache_hit_rate=rep.plan_cache_hit_rate)
        history.append(row)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {row['grad_norm']:8.3f} lr {row['lr']:.2e} "
                  f"({dt / (step + 1):.2f}s/step)")
            if fleet_session is not None:
                print(f"           {metrics['fleet'].log_line()}")
        if mgr is not None:
            # copies every leaf to the host before the next in-place step
            mgr.maybe_save(step, {"params": params, "opt": opt_state},
                           {"loss": loss})
        if not np.isfinite(loss):
            raise SystemExit(f"loss diverged at step {step}")

    first = np.mean([h["loss"] for h in history[:5]])
    last = np.mean([h["loss"] for h in history[-5:]])
    print(f"loss: first5={first:.4f} last5={last:.4f} "
          f"improved={first - last:.4f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
