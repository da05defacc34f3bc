"""Production-mesh dry run: one rank of an (arch x input-shape) step on
the production meshes, with its per-device memory and roofline terms
(port of ``src/repro/launch/dryrun.py``).

The reference lowers and compiles the step for a 16 GB TPU v5e pod and
reads memory and costs from the compiled artifact.  The port runs rank 0
of the mesh in this process, in a fake process group of the mesh's full
world size (``torch.testing._internal.distributed.fake_pg``): the
collectives move no data, so after the first one the values are
meaningless, and only the sizes, counts and costs stand
(``launch.cost_analysis`` counts the collectives as they are issued).

* On the card (the default, ``--device cuda``) rank 0's step runs for
  real at its local shapes, with the kernels.  ``memory.peak_per_device``
  is ``torch.cuda.max_memory_allocated`` over building the rank's
  inputs and running the step, and ``fits_hbm`` compares it with the
  card's ``total_memory``.
* With ``--device cpu`` the step is traced under ``FakeTensorMode``
  (nothing is allocated; the kernels' plain versions run), and the peak
  is the tracked high-water mark of live tensor bytes.

``memory.measured_by`` says which of the two it is.  On the card the
step also runs under ``torch.profiler`` (the card's activity only):
``step_ms`` is the time between CUDA events around it, the host's gaps
included; ``device_busy_ms`` the time in which the card ran a kernel,
copy or fill (the union of the profiler's device intervals), and
``device_idle_share`` the rest's share of ``step_ms``.  Cost terms the
port counts itself are ``cost.flops`` and ``cost.bytes``
(``launch.cost_analysis``): ``cost.flops`` counts products (``mm``,
``bmm``, ``addmm``, ``baddbmm`` and the kernels' own work), not
elementwise arithmetic or reductions, so a step whose contractions are
elementwise (the sharded decode's scores) can read a
``useful_flops_ratio`` above 1.  The roofline divides them, and the
collective bytes, by the H100's rates (``launch.mesh.HW``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multi-pod] [--mesh 4x4] [--device cpu] \\
      [--layers N] [--out out.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _local_tensor(spec, mesh, device, fill):
    """A DTensor of ``spec``'s global shape whose local block (rank 0's)
    is ``fill(local_shape, dtype, device)``."""
    import torch
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.parallel.sharding import placements
    pl = placements(spec.spec, mesh)
    with unset_fake_temporarily():      # the mesh's coordinates are real
        shape, _ = compute_local_shape_and_global_offset(spec.shape, mesh,
                                                         pl)
    local = fill(tuple(shape), spec.dtype, device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(spec.shape),
                              stride=torch.empty(spec.shape,
                                                 device="meta").stride())


def make_inputs_for(cfg, shape, device):
    """``step_and_specs``' ``make_inputs``: rank 0's blocks of random
    params (N(0, 0.02) in their dtype), zero moments and caches, random
    tokens; a decode cache is full (its position the last slot)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.launch.specs import TensorSpec, cache_len_for
    from repro_torch.optim.adam import AdamState

    def normal(shp, dt, dev):
        return (torch.randn(shp, device=dev) * 0.02).to(dt)

    def zeros(shp, dt, dev):
        return torch.zeros(shp, dtype=dt, device=dev)

    def tokens(shp, dt, dev):
        return torch.randint(0, cfg.vocab_size, shp, device=dev).to(dt)

    def build(specs, rules):
        mesh = rules.mesh

        def leaf(fill):
            return lambda s: _local_tensor(s, mesh, device, fill)

        def batch(tree):
            out = {}
            for k, s in tree.items():
                if k == "cache":
                    out[k] = cache(s)
                elif s.dtype in (torch.int32, torch.int64):
                    out[k] = leaf(tokens)(s)
                else:
                    out[k] = leaf(normal)(s)
            return out

        def cache(tree):
            out = {}
            for k, s in tree.items():
                if k == "pos":
                    # a plain scalar, read on the host: every rank holds it
                    from torch._subclasses.fake_tensor import \
                        unset_fake_temporarily
                    with unset_fake_temporarily():
                        out[k] = torch.full((), cache_len_for(cfg, shape)
                                            - 1, dtype=s.dtype,
                                            device=device)
                else:
                    out[k] = leaf(zeros)(s)
            return out

        params = T.map_tree(leaf(normal), specs[0])
        if shape.kind == "train":
            from torch._subclasses.fake_tensor import \
                unset_fake_temporarily
            o = specs[1]
            with unset_fake_temporarily():     # read on the host
                step = torch.zeros((), dtype=torch.int32)
            opt = AdamState(step=step,
                            mu=T.map_tree(leaf(zeros), o.mu),
                            nu=T.map_tree(leaf(zeros), o.nu))
            return params, opt, batch(specs[2])
        if shape.kind == "prefill":
            return params, batch(specs[1])
        toks = specs[2]
        return (params, cache(specs[1]),
                leaf(tokens)(TensorSpec(toks.shape, toks.dtype, toks.spec)))
    return build


def _device_busy_ms(prof) -> float:
    """Milliseconds in which the card ran anything during ``prof``: the
    union of its device events' intervals, read from the raw events
    without the profiler's per-op post-processing (minutes over a
    full-depth step's launches)."""
    from torch.autograd import DeviceType
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation())
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def _launch_counts():
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    return {"B1": bg.launches, "B2": bg.batched_launches,
            "B4": fa.launches, "B5": dec.flash_decode_launches}


def _reset_launch_counts():
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    bg.launches = bg.batched_launches = 0
    fa.launches = 0
    dec.flash_decode_launches = 0


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            mode_override: str = None, mesh_override: str = None,
            fsdp: bool = False, kv_quant: bool = False,
            device: str = "cuda", layers: int = None) -> dict:
    """Rank 0 of one (arch, shape) step on the production mesh (or
    ``mesh_override``, e.g. "4x4" or "2x2x4"); returns the reference's
    JSON keys where their meaning carries over."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import (HW, make_mesh, make_production_mesh,
                                         production_shape)
    from repro_torch.parallel.sharding import make_rules

    dev = resolve_device(device)
    full = cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    shape = INPUT_SHAPES[shape_name]
    if mesh_override:
        dims = tuple(int(x) for x in mesh_override.split("x"))
        axes = ("pod", "data", "model")[-len(dims):]
    else:
        dims, axes = production_shape(multi_pod=multi_pod)
    n_chips = 1
    for d in dims:
        n_chips *= d
    if dist.is_initialized():
        dist.destroy_process_group()
    CA.init_fake_group(n_chips)
    mesh = (make_mesh(dims, axes, dev.type) if mesh_override
            else make_production_mesh(multi_pod=multi_pod,
                                      device_type=dev.type))
    mode = mode_override or {"train": "train", "prefill": "prefill",
                             "decode": "decode"}[shape.kind]
    # big models can't replicate weights across 'data' even at serve
    # time: CLEAVE 2-D row x column weight sharding
    weight_2d = (mode == "train") or full.n_params() > 30e9
    rules = make_rules(mesh, mode=mode, weight_2d=weight_2d, fsdp=fsdp)
    # a depth cut keeps the full model's microbatches (and so each
    # microbatch's activations)
    mb = ST.default_microbatches(full, shape, rules)

    costs = CA.Costs()
    fake = None
    if dev.type == "cpu":
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake = FakeTensorMode(allow_non_fake_inputs=True)
    else:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with (fake if fake is not None else contextlib.nullcontext()):
        fn, inputs, _ = ST.step_and_specs(
            cfg, shape, rules, microbatches=mb, kv_quant=kv_quant,
            make_inputs=make_inputs_for(cfg, shape, dev))
        t_build = time.perf_counter() - t0
        _reset_launch_counts()
        prof = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        with CA.counting(costs, track_live=fake is not None) as mode_, \
                (prof if prof is not None else contextlib.nullcontext()):
            mode_.track(inputs)
            if prof is not None:
                ev0.record()
            t1 = time.perf_counter()
            out = fn(*inputs)
            if prof is not None:
                ev1.record()
                torch.cuda.synchronize()
            t_step = time.perf_counter() - t1
        launches = _launch_counts()
        del out, inputs
    if dev.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated())
        hbm = int(torch.cuda.get_device_properties(dev).total_memory)
        measured_by = "torch.cuda.max_memory_allocated"
        step_ms = ev0.elapsed_time(ev1)
        busy_ms = _device_busy_ms(prof)
        idle = 1.0 - busy_ms / step_ms
    else:
        peak = int(costs.peak_live_bytes)
        hbm = int(HW["hbm_bytes"])
        measured_by = "FakeTensorMode live-bytes high-water mark"
        step_ms = busy_ms = idle = None
    dist.destroy_process_group()

    mf = CA.model_flops(cfg, shape)
    t_compute = costs.flops / HW["peak_flops_bf16"]
    t_memory = costs.bytes / HW["hbm_bw"]
    t_collective = costs.collective_bytes / HW["ici_bw_per_link"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(dims),
        "axes": list(axes),
        "n_chips": n_chips,
        "mode": mode,
        "device": dev.type,
        "n_layers": cfg.n_layers,
        "microbatches": mb if shape.kind == "train" else None,
        "build_s": round(t_build, 2),
        "step_s": round(t_step, 2),
        "step_ms": step_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": idle,
        "memory": {
            "peak_per_device": peak,
            "hbm_bytes": hbm,
            "fits_hbm": peak < hbm,
            "measured_by": measured_by,
        },
        "cost": {"flops": costs.flops, "bytes": costs.bytes,
                 "kernel_flops": costs.kernel_flops},
        "collectives": costs.collectives,
        "collective_bytes": costs.collective_bytes,
        "launches": launches,
        "model_flops": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": ((mf / n_chips) / costs.flops
                               if costs.flops else None),
        "roofline": terms,
        "dominant": dominant,
        "params": cfg.n_params(),
        "active_params": cfg.active_params(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", default=None, help="sharding-rule override")
    ap.add_argument("--mesh", default=None,
                    help="override mesh dims, e.g. 4x2 or 2x4x2")
    ap.add_argument("--fsdp", action="store_true",
                    help="store weights 2-D, gather per layer")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache for decode shapes")
    ap.add_argument("--device", default="cuda",
                    help="cuda: rank 0 runs on the card; cpu: traced "
                         "under FakeTensorMode")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (default: the "
                         "config's own)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import INPUT_SHAPES

    combos = []
    if args.all:
        from repro_torch.configs.base import list_configs
        assigned = [a for a in list_configs()
                    if not a.startswith(("opt-", "llama2-"))]
        combos = [(a, s) for a in assigned for s in INPUT_SHAPES]
    else:
        combos.append((args.arch, args.shape))

    results = []
    for arch, shape in combos:
        try:
            r = run_one(arch, shape, args.multi_pod, args.mode, args.mesh,
                        args.fsdp, args.kv_int8, args.device, args.layers)
            results.append(r)
            print(f"OK   {arch:24s} {shape:12s} mesh={r['mesh']} "
                  f"step={r['step_s']:7.1f}s "
                  f"mem/dev={r['memory']['peak_per_device'] / 1e9:6.2f}GB "
                  f"fits={r['memory']['fits_hbm']} "
                  f"dominant={r['dominant']}")
            print(json.dumps({k: r[k] for k in
                              ("memory", "cost", "collective_bytes",
                               "roofline", "useful_flops_ratio",
                               "launches")}, default=str))
        except Exception as e:  # noqa: BLE001 -- reported per combo
            print(f"FAIL {arch} {shape}: {type(e).__name__}: {e}")
            results.append({"arch": arch, "shape": shape, "error": str(e)})
            if not args.all:
                raise
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    bad = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(bad)}/{len(results)} combos ran")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
