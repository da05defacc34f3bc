"""Where a fleet decode step's time goes on the card.

Builds the full-width serving session of ``chip_smoke.py`` (``--arch``,
llama3-8b, granite-moe-1b-a400m, deepseek-v2-236b or qwen2-vl-72b, at
``--layers`` depth (omitted: the config's own), bf16, 4 slots, 16-device
fleet), runs one warm-up step, times
``--steps`` decode steps untraced, then traces as many with
``torch.profiler`` and prints one JSON object: wall time per step
(untraced and traced), device kernel time per step, the device's idle
share, the kernel time launched under the
``fleet.fwd``, ``ops.stage_copy``, ``moe.experts``, ``moe.dispatch`` and
``mla.decode`` ranges (MoE: the expert products on the batched block GEMM,
and routing, sort, scatter and combine; MLA: the absorbed decode's
einsums against the latent cache), the batched block GEMM's launches per
step, and the kernels that take the device time, each with its time and
launches per step.  seamless-m4t-medium and hymba-1.5b, whose states the
session does not page (as in the reference), are profiled on their
monolithic decode instead: for seamless a prefill of the prompts with 2 *
prompt-len encoder frames and the cross K/V of those frames
(``encdec.decode_cache``), for hymba ``launch/serve.py``'s prefill and cache
(``launch.serve.prefill_cache``), then ``decode_step``s (no fleet GEMM;
the attention on the flash-decode kernel, hymba's over its 128 meta
tokens and the cache; hymba's SSM step in plain torch, under the
``ssm.decode`` range).

Usage (on a machine with a CUDA card):
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      [--arch granite-moe-1b-a400m|deepseek-v2-236b|qwen2-vl-72b|\
              seamless-m4t-medium|hymba-1.5b] [--layers 4] \
      [--steps 3] \
      [--out profile_serve.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

RANGES = ("fleet.fwd", "ops.stage_copy", "moe.experts", "moe.dispatch",
          "mla.decode", "ssm.decode")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val is not None:
            return float(val)
    return 0.0


def _monolithic_decoder(cfg, dev, prompts, n_gen):
    """The monolithic decode at bf16 params, over a cache of prompt +
    ``n_gen`` slots: the encoder-decoder's ``encdec.decode_cache`` (a
    prefill of ``prompts`` with 2x as many random encoder frames), else
    ``launch/serve.py``'s ``prefill_cache``.  Each call of the returned
    function decodes one greedy token for every prompt."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import prefill_cache
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen)
    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    B, P = toks.shape
    if cfg.enc_dec:
        feats = torch.randn((B, 2 * P, cfg.d_model), generator=gen,
                            device=dev)
        logits, cache = encdec.decode_cache(cfg, params, toks, feats,
                                            P + n_gen)
    else:
        with torch.no_grad():
            logits, cache = prefill_cache(cfg, params, toks, P + n_gen)
    state = {"cache": cache, "tok": logits[:, -1:].argmax(-1)}

    @torch.no_grad()
    def step():
        lg, state["cache"] = M.decode_step(cfg, params, state["cache"],
                                           state["tok"])
        state["tok"] = lg[:, -1:].argmax(-1)

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=("llama3-8b", "granite-moe-1b-a400m",
                             "deepseek-v2-236b", "qwen2-vl-72b",
                             "seamless-m4t-medium", "hymba-1.5b"))
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's depth (omitted: keep it)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.configs.base import get_config

    dev = resolve_device("cuda")
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.launch.profile_train import _range_kernel_us
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    n_gen = 2 * args.steps + 1
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               .astype(np.int32) for _ in range(args.slots)]
    if cfg.enc_dec or cfg.hybrid_parallel:
        # the monolithic decode runs no fleet GEMM: no step reports
        step, reports = _monolithic_decoder(cfg, dev, prompts, n_gen), []
    else:
        rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                                device=dev)
        sess = rt.serve_session(slots=args.slots, page_size=16,
                                max_len=args.prompt_len + n_gen,
                                backend="torch", dtype_policy="bf16")
        for p in prompts:
            sess.submit(p, max_new=n_gen)
        step, reports = sess.step, sess.step_reports
    step()                                        # admission + warm-up
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize(dev)
    wall_untraced = time.perf_counter() - t0

    n_b2 = bg.batched_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    n_b2 = bg.batched_launches - n_b2

    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue                  # a profiler range's span, no kernel
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            k = kernels.setdefault(evt.key, [0.0, 0])
            k[0] += us
            k[1] += evt.count
    device_s = sum(v[0] for v in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:args.top]
    recs = [r for s in reports[1 + args.steps:] for r in s.records]
    report = {
        "card": torch.cuda.get_device_name(dev),
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "slots": args.slots, "steps": args.steps,
        "wall_s_per_step_untraced": wall_untraced / args.steps,
        "wall_s_per_step": wall / args.steps,
        "device_kernel_s_per_step": device_s / args.steps,
        "device_idle_share": max(0.0, 1.0 - device_s / wall),
        "fleet_exec_s_per_step": sum(r.exec_time for r in recs)
        / args.steps,
        "gemms_per_step": len(recs) // args.steps,
        "range_kernel_ms_per_step": {
            k: v / 1e3 / args.steps
            for k, v in _range_kernel_us(prof, RANGES).items()},
        "block_gemm_batched_launches_per_step": n_b2 / args.steps,
        "top_kernels": [
            {"name": name[:120], "ms_per_step": us / 1e3 / args.steps,
             "launches_per_step": cnt / args.steps,
             "share_of_device": us / 1e6 / max(device_s, 1e-12)}
            for name, (us, cnt) in top],
    }
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
