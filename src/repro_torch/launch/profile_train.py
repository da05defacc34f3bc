"""Where a fleet training step's time goes on the card.

Builds the full-width training session of ``chip_smoke.py`` (``--arch``,
llama3-8b, rwkv6-7b, granite-moe-1b-a400m, deepseek-v2-236b, qwen2-vl-72b,
seamless-m4t-medium or hymba-1.5b, at ``--layers`` depth (omitted: the
config's own),
bf16 params and policy, batch 8 x 128, 16-device fleet, params and
moments updated in place; qwen2-vl's batches carry 32 patch embeddings a
row on a 4 x 8 grid of M-RoPE positions, seamless's 256 encoder frames a
row, as ``chip_smoke.py``'s mrope_full and encdec_full), runs one warm-up step
(cold plan solves), times ``--steps`` steps untraced, traces as many with
``torch.profiler``, times every band GEMM, WKV and batched block GEMM
(MoE experts) launch of as many more with CUDA events, and prints one
JSON object: wall time per step (untraced and traced), the fleet
executors' host time by GEMM kind, the step's spans and counters
(``FleetStepReport.spans``, self milliseconds a step by span, and
``counters``, untraced and traced), the fleet GEMMs' bound on the card,
device kernel time per step and the device's idle share (one less the
union of its kernel, copy and set intervals over the traced steps' wall
time), the kernel time launched under each span of the step
(``fleet.fwd``, ``fleet.dA``, ``fleet.dW`` and their phases
``fleet.plan``, ``fleet.stage``, ``fleet.launch``, ``fleet.readback``,
``fleet.scatter``, ``fleet.sync``, ``fleet.verify`` and
``fleet.oracle``, ``ops.stage_copy`` for the padded and transposed
operand copies, ``ps.forward``, ``ps.backward``, ``ps.adam``,
``ps.sync``, for RWKV ``rwkv.wkv_backward``,
the WKV backward's torch recompute, for MoE ``moe.experts``, the
expert products' forward and backward with their transposed copies, and
``moe.dispatch``, routing, sort, scatter and combine in the forward, and
for hymba ``ssm.scan`` and ``ssm.scan_backward``, the selective scan's
forward and its chunk-by-chunk recompute and backward) --
the sum of the kernels launched inside the range, not the range's span on
the device timeline -- the band GEMM's time and launches per step by
fleet GEMM kind, the WKV kernel's, the batched block GEMM's and the
flash-attention kernel's time and launches per step (CUDA events, and
their own entries in the trace), the peak device memory, and the kernels
that take the device time, each with its time and launches per step.
The port's kernels are launched through ctypes, which the profiler ties
to no range: they are timed by CUDA events and read by kernel name.

Usage (on a machine with a CUDA card):
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      [--arch rwkv6-7b|granite-moe-1b-a400m|deepseek-v2-236b|\\
              qwen2-vl-72b|seamless-m4t-medium|hymba-1.5b] \\
      [--layers 4] [--steps 2] \\
      [--out profile_train.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

RANGES = ("fleet.fwd", "fleet.dA", "fleet.dW", "fleet.plan", "fleet.stage",
          "fleet.launch", "fleet.readback", "fleet.scatter", "fleet.sync",
          "fleet.verify", "fleet.oracle", "ops.stage_copy", "ps.forward",
          "ps.backward", "ps.adam", "ps.sync", "rwkv.wkv_backward",
          "moe.experts", "moe.dispatch", "ssm.scan", "ssm.scan_backward")
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
ARCHS = ("llama3-8b", "rwkv6-7b", "granite-moe-1b-a400m", "deepseek-v2-236b",
         "qwen2-vl-72b", "seamless-m4t-medium", "hymba-1.5b")
# one H100 SXM at 700 W (NVIDIA data sheet): memory rate, dense bf16 rate
PEAK_BW, PEAK_BF16 = 3.35e12, 989e12


def _gemm_bound_ms(records) -> float:
    """Least card time of a step's fleet GEMMs: per GEMM the larger of its
    bytes (bf16 operands read once, the f32 product written once) over the
    memory rate and its FLOPs over the bf16 rate, summed."""
    return sum(max((2 * (r.m * r.n + r.n * r.q) + 4 * r.m * r.q) / PEAK_BW,
                   r.flops / PEAK_BF16) for r in records) * 1e3


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val is not None:
            return float(val)
    return 0.0


def _range_kernel_us(prof, ranges=RANGES) -> dict:
    """Kernel time by enclosing profiler range: each kernel is attached to
    the innermost host event open when it was launched (a torch op, or
    the range itself for the port's ctypes-launched kernels); count it
    there and in every enclosing range.  A range's own span on the device
    timeline comes back as a "kernel" of the range's name, and is not
    counted."""
    out = dict.fromkeys(ranges, 0.0)
    for evt in prof.events():
        us = sum(k.duration for k in getattr(evt, "kernels", [])
                 if k.name != evt.name)
        node, seen = evt, set()
        while us and node is not None:
            if node.name in ranges and node.name not in seen:
                seen.add(node.name)
                out[node.name] += us
            node = node.cpu_parent
    return out


def _device_busy_s(prof) -> float:
    """The union of the card's kernel, copy and set intervals in the
    trace, in seconds: the time it did work.  A span's own interval on
    the device timeline is no work; where this torch's events carry no
    activity type, a span is told by its name ("fleet.fwd")."""
    iv = []
    for e in prof.profiler.kineto_results.events():
        if "cuda" not in str(e.device_type()).lower():
            continue
        if hasattr(e, "activity_type"):
            if e.activity_type() not in DEVICE_WORK:
                continue
        elif "." in e.name() and "::" not in e.name():
            continue
        if hasattr(e, "start_ns"):
            iv.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        else:
            s = e.start_us() * 1000
            iv.append((s, s + e.duration_us() * 1000))
    busy, end = 0, None
    for s, t in sorted(iv):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy * 1e-9


def _per_step(reps, field, scale=1.0) -> dict:
    """Mean a step of each entry of the reports' ``spans`` or
    ``counters``."""
    out = {}
    for r in reps:
        for k, v in getattr(r, field).items():
            out[k] = out.get(k, 0.0) + v * scale / len(reps)
    return dict(sorted(out.items()))


@contextlib.contextmanager
def _band_gemm_events(torch):
    """For the extent of the block, time every band GEMM launch with CUDA
    events and tag it with the kind (fwd, dA, dW) of the fleet GEMM that
    issued it; yields the list of ``(kind, start, end)``.  The kernel is
    launched through ctypes, which the profiler ties to no range."""
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.train_loop.fleet_gemm import FleetGemmSession
    launch, execute = bg.block_gemm_batched_shared, FleetGemmSession._execute
    events, kind = [], [None]

    def timed_launch(a, b):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(a, b)
        end.record()
        events.append((kind[0], start, end))
        return out

    def tagged_execute(self, a, b, k):
        kind[0] = k
        return execute(self, a, b, k)

    bg.block_gemm_batched_shared = timed_launch
    FleetGemmSession._execute = tagged_execute
    try:
        yield events
    finally:
        bg.block_gemm_batched_shared = launch
        FleetGemmSession._execute = execute


@contextlib.contextmanager
def _launch_events(torch, module, name):
    """For the extent of the block, time every call of ``module.name`` (a
    kernel wrapper) with CUDA events; yields the list of ``(start, end)``."""
    launch, events = getattr(module, name), []

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    setattr(module, name, timed_launch)
    try:
        yield events
    finally:
        setattr(module, name, launch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCHS)
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's depth (omitted: keep it)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           grid_positions, modality_stubs)
    from repro_torch.models import model as M
    from repro_torch.optim import adam

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    opt_cfg = adam.AdamConfig(warmup_steps=3, total_steps=100)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=0))
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # PS-local GEMMs
        sess = rt.train_session(opt_cfg, backend="torch",
                                dtype_policy="bf16", q_chunk=64, k_chunk=64,
                                loss_chunk=64)
    batches = []
    for i in range(1 + 3 * args.steps):
        raw = data.batch(i)
        raw.update(modality_stubs(cfg, args.batch, args.seq, i))
        if cfg.m_rope:
            raw["positions_mrope"] = grid_positions(args.batch, args.seq,
                                                    (4, 8))
        batches.append({k: torch.as_tensor(v, device=dev)
                        for k, v in raw.items()})

    def run(steps):
        nonlocal params, opt
        reps = []
        for b in steps:
            # in place: deepseek-v2-236b's layer would not fit the card
            # with a second copy of its params and moments
            params, opt, met = sess.step(params, opt, b, donate=True)
            reps.append(met["fleet"])
        return reps

    t0 = time.perf_counter()
    run(batches[:1])                              # warm-up: cold plans
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    untraced = run(batches[1:1 + args.steps])
    wall_untraced = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced = run(batches[1 + args.steps:1 + 2 * args.steps])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wkv
    with _band_gemm_events(torch) as events, \
            _launch_events(torch, wkv, "wkv6") as wkv_ev, \
            _launch_events(torch, bg, "block_gemm_batched") as b2_ev, \
            _launch_events(torch, fa, "attend") as fa_ev:
        timed = run(batches[1 + 2 * args.steps:])
    torch.cuda.synchronize(dev)
    band_ms = {}
    for kind, start, end in events:
        band_ms[kind] = band_ms.get(kind, 0.0) \
            + start.elapsed_time(end) / args.steps

    n = args.steps
    kernels = {}
    for evt in prof.key_averages():
        if evt.key in RANGES or getattr(evt, "is_user_annotation", False):
            continue
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            k = kernels.setdefault(evt.key, [0.0, 0])
            k[0] += us
            k[1] += evt.count
    device_s = sum(v[0] for v in kernels.values()) / 1e6
    busy_s = _device_busy_s(prof)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:args.top]

    def by_kind(reps):
        out = {}
        for r in (r for rep in reps for r in rep.records):
            out[r.kind] = out.get(r.kind, 0.0) + r.exec_time / len(reps)
        return out

    report = {
        "card": torch.cuda.get_device_name(dev),
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": args.batch,
        "seq": args.seq, "steps": n, "warmup_step_s": warm_s,
        "wall_s_per_step_untraced": wall_untraced / n,
        "wall_s_per_step": wall / n,
        "fleet_exec_s_per_step_untraced":
            sum(r.fleet_exec_time for r in untraced) / n,
        "fleet_exec_s_by_kind_untraced": by_kind(untraced),
        "span_ms_per_step_untraced": _per_step(untraced, "spans", 1e3),
        "counters_per_step_untraced": _per_step(untraced, "counters"),
        "span_ms_per_step": _per_step(traced, "spans", 1e3),
        "gemms_per_step": untraced[0].n_gemms,
        "gemm_tflop_per_step": untraced[0].gemm_flops / 1e12,
        "gemm_bound_ms_per_step": _gemm_bound_ms(untraced[0].records),
        "device_kernel_s_per_step": device_s / n,
        "device_busy_s_per_step": busy_s / n,
        "device_idle_share": 1.0 - busy_s / wall,
        "range_kernel_ms_per_step": {
            k: v / 1e3 / n for k, v in _range_kernel_us(prof).items()},
        "band_gemm_ms_by_kind_per_step": band_ms,
        "band_gemm_launches_by_kind_per_step": {
            k: sum(1 for e in events if e[0] == k) / args.steps
            for k in band_ms},
        "wkv_ms_per_step": sum(s.elapsed_time(e) for s, e in wkv_ev) / n,
        "wkv_launches_per_step": len(wkv_ev) / n,
        "wkv_kernel_ms_per_step_traced": sum(
            us for name, (us, _) in kernels.items() if "wkv6_kernel" in name)
        / 1e3 / n,
        "block_gemm_batched_ms_per_step": sum(
            s.elapsed_time(e) for s, e in b2_ev) / n,
        "block_gemm_batched_launches_per_step": len(b2_ev) / n,
        "flash_ms_per_step": sum(s.elapsed_time(e) for s, e in fa_ev) / n,
        "flash_launches_per_step": len(fa_ev) / n,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "losses": [r.loss for r in untraced + traced + timed],
        "top_kernels": [
            {"name": name[:120], "ms_per_step": us / 1e3 / n,
             "launches_per_step": cnt / n,
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
