#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits non-zero:

1. build   -- compile every CUDA kernel from ``src/repro_torch/csrc``.
2. gemm    -- the band GEMM kernel against its plain version at the decode
              shapes of llama3-8b (bf16, and IEEE f32 with TF32 off), timed
              beside the plain version, one ``torch.matmul`` and its bound.
3. paged   -- the paged decode kernel against its plain version (shuffled
              page tables, ragged lengths, a length-0 request), timed.
4. reduced -- ``llama3-8b.reduced()`` fleet serving under the f32 policy
              with a device failure: greedy tokens equal the port's
              monolithic decode, every step verified, tasks recovered.
5. full    -- the main path: llama3-8b at full width (4 layers, bf16),
              4 slots, fleet serving through both kernels with a device
              failure at step 2 and the paged read checked every step; the
              launch counts are read around this run only.  Then one
              full-width GEMM with a poisoning device must be caught and
              corrected.

Then a ``kernels`` line, the card's name and power limit as
``nvidia-smi`` gives them, and the result line.  ``--phases`` runs a
subset (for bring-up); the result line needs all of them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("build", "gemm", "paged", "reduced", "full")
# one H100 SXM, dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BW = 3.35e12                 # bytes/s
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # FLOP/s, f32 off-core


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BW * 1e3
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls,
    after warm-up (CUDA events)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / iters)
    ts.sort()
    return ts[len(ts) // 2]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ------------------------------------------------------------------ phases --

def phase_build():
    from repro_torch.kernels import _build
    paths = _build.build_all()
    regs = {}
    for name in paths:
        log = _build.build_dir() / f"{name}.log"
        regs[name] = [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": _build.build_seconds,
          "libraries": {n: os.path.relpath(p, ROOT)
                        for n, p in paths.items()},
          "ptxas": regs})


# the decode step's band GEMMs at full width: (k, q, launches per step)
def decode_gemm_shapes(cfg):
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = [(d, cfg.n_heads * hd, 1), (d, cfg.n_kv_heads * hd, 2),
                 (cfg.n_heads * hd, d, 1), (d, cfg.d_ff, 2),
                 (cfg.d_ff, d, 1)]
    shapes = [(k, q, c * cfg.n_layers) for k, q, c in per_layer]
    return shapes + [(d, cfg.vocab_size, 1)]


def phase_gemm(cfg):
    import torch
    from repro_torch.kernels import block_gemm as bg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, step = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                      "max_abs_err": 0.0}
    cases = [(1, 128, k, q, c) for k, q, c in decode_gemm_shapes(cfg)]
    cases += [(3, 128, 4096, 4096, 0), (3, 100, 1000, 777, 0)]
    for G, m, k, q, per_step in cases:
        a32 = torch.randn((G, m, k), generator=gen, device=dev)
        b32 = torch.randn((k, q), generator=gen, device=dev) / k ** 0.5
        row = {"G": G, "m": m, "k": k, "n": q, "per_step": per_step}
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            a, b = a32.to(dt), b32.to(dt)
            got = bg.block_gemm_batched_shared(a, b)
            want = bg.block_gemm_batched_shared_plain(a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            # both sides sum exact products in f32; only the order differs
            check(rel <= 1e-5, f"band GEMM {name} {row}: rel err {rel:.3g}")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_rel_err"] = rel
        if per_step or G == 3 and m == 128:
            a, b = a32.bfloat16(), b32.bfloat16()
            row["kernel_ms"] = time_ms(
                lambda: bg.block_gemm_batched_shared(a, b))
            row["plain_ms"] = time_ms(
                lambda: bg.block_gemm_batched_shared_plain(a, b))
            row["library_ms"] = time_ms(lambda: torch.matmul(a, b))
            nbytes = 2 * (G * m * k + k * q) + 4 * G * m * q
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 2.0 * G * m * k * q, "bfloat16")
            if per_step:
                for key, src in (("ms", "kernel_ms"),
                                 ("plain_ms", "plain_ms"),
                                 ("library_ms", "library_ms")):
                    step[key] += per_step * row[src]
                step["bytes_ms"] += per_step * nbytes / PEAK_BW * 1e3
                step["ops_ms"] += per_step * (2.0 * G * m * k * q
                                              / PEAK_OPS["bfloat16"] * 1e3)
                step["max_abs_err"] = max(step["max_abs_err"],
                                          row["bfloat16_max_abs_err"])
        rows.append(row)
        emit({"phase": "gemm", **row})
        del a32, b32
    step["bound_ms"] = max(step["bytes_ms"], step["ops_ms"])
    step["bound_by"] = ("bytes" if step["bytes_ms"] >= step["ops_ms"]
                        else "operations")
    return step


def _paged_case(dev, gen, B, K, G, D, page, n_pages, lengths, dtype):
    import torch
    maxp = max(1, -(-max(lengths) // page))
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    pt = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    q = torch.randn((B, K, G, D), generator=gen, device=dev)
    kp = torch.randn((n_pages, page, K, D), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_pages, page, K, D), generator=gen,
                     device=dev).to(dtype)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln


def phase_paged():
    import torch
    from repro_torch.kernels import decode_attention as dec
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, K, G, D, page = 4, 8, 4, 128, 16
    out = {}
    for lengths, tag in (([37, 16, 0, 100], "ragged"),
                         ([23, 23, 23, 23], "main_path")):
        for name, dt, tol in (("float32", torch.float32, 2e-4),
                              ("bfloat16", torch.bfloat16, 1e-2)):
            args = _paged_case(dev, gen, B, K, G, D, page, 64, lengths, dt)
            got = dec.flash_decode_paged(*args)
            want = dec.flash_decode_paged_plain(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            err_rel = err / max(1.0, float(want.float().abs().max()))
            zero_ok = all(bool((got[b] == 0).all())
                          for b in range(B) if lengths[b] == 0)
            # f32: sums in another order (the reference's 2e-4); bf16: the
            # output is rounded to bf16 (one ulp in [1, 2) is 7.8e-3)
            check(err_rel <= tol and zero_ok,
                  f"paged decode {tag} {name}: max abs err {err:.3g}")
            row = {"phase": "paged", "case": tag, "dtype": name,
                   "B": B, "K": K, "G": G, "D": D, "page": page,
                   "lengths": lengths, "max_abs_err": err}
            if tag == "main_path" and name == "float32":
                row["kernel_ms"] = time_ms(
                    lambda: dec.flash_decode_paged(*args), iters=50)
                row["plain_ms"] = time_ms(
                    lambda: dec.flash_decode_paged_plain(*args), iters=50)
                row["library_ms"] = None
                ntok = sum(lengths)
                nbytes = (4 * B * K * G * D * 2 + 2 * 4 * ntok * K * D
                          + 4 * B * args[3].shape[1] + 4 * B)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, 4.0 * ntok * K * G * D, "float32")
                out = row
            emit(row)
    return out


def _monolithic_greedy(cfg, params, prompt, n_new, cache_len, dev):
    import torch
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, 1, cache_len, device=dev)
    lg = None
    for t in prompt:
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.tensor([[int(t)]], device=dev))
    toks = []
    for _ in range(n_new):
        tok = int(torch.argmax(lg[0, 0, :cfg.vocab_size]))
        toks.append(tok)
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.tensor([[tok]], device=dev))
    return toks


def phase_reduced():
    import numpy as np
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.configs.base import get_config
    cfg = get_config("llama3-8b").reduced()
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cuda")
    sess = rt.serve_session(slots=3, page_size=4, max_len=16,
                            backend="torch", dtype_policy="f32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
               for _ in range(3)]
    for p in prompts:
        sess.submit(p, max_new=4)
    rep = sess.run(fail_ids=[2], fail_at_step=1)
    got = {r.rid: r.tokens for r in sess.batcher.finished}
    want = {i: _monolithic_greedy(cfg, sess.params, p, 4, 16,
                                  torch.device("cuda"))
            for i, p in enumerate(prompts)}
    verified = all(s.verified for s in sess.step_reports)
    emit({"phase": "reduced", "tokens_match": got == want,
          "all_verified": verified, "n_recovered": rep.n_recovered,
          "failed_ids": list(rep.failed_ids), "n_steps": rep.n_steps})
    check(got == want, f"reduced greedy tokens {got} != monolithic {want}")
    check(verified, "reduced: a step failed verification")
    check(rep.n_recovered > 0 and rep.failed_ids == (2,),
          "reduced: the failure did not recover tasks")


def phase_full(cfg):
    import numpy as np
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    slots, P, n_gen, page = 4, 16, 8, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    sess = rt.serve_session(params, slots=slots, page_size=page,
                            max_len=P + n_gen, backend="torch",
                            dtype_policy="bf16", check_paged_read=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, P).astype(np.int32)
               for _ in range(slots)]
    for p in prompts:
        sess.submit(p, max_new=n_gen)

    bg.launches = 0
    dec.launches = 0
    t0 = time.perf_counter()
    first = sess.step()
    first_logits = sess.last_logits.clone()
    rep = sess.run(fail_ids=[3], fail_at_step=1)   # the session's step 2
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {"band_gemm": bg.launches, "paged_decode": dec.launches}

    # the first step against the port's monolithic decode on the same
    # inputs: per-request prefill of prompt[:-1] into an f32 cache (the
    # session's pool dtype), then one decode_step of prompt[-1]
    cache_len = sess.cache_len
    Lc, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cache = {nm: torch.zeros((Lc, slots, cache_len, K, hd), device=dev)
             for nm in ("k", "v")}
    for b, p in enumerate(prompts):
        _, pc = M.prefill(cfg, params, {"tokens": torch.as_tensor(
            p[None, :P - 1].astype(np.int64), device=dev)})
        for nm in ("k", "v"):
            cache[nm][:, b, :P - 1] = pc[nm][:, 0].float()
    cache["pos"] = torch.full((slots,), P - 1, dtype=torch.int32,
                              device=dev)
    toks = torch.as_tensor(np.stack([p[-1:] for p in prompts])
                           .astype(np.int64), device=dev)
    ref_logits, _ = M.decode_step(cfg, params, cache, toks)
    V = cfg.vocab_size
    diff = (first_logits[..., :V] - ref_logits[..., :V]).float()
    rel_l2 = float(diff.norm() / ref_logits[..., :V].float().norm())
    argmax_eq = bool((first_logits[..., :V].argmax(-1)
                      == ref_logits[..., :V].argmax(-1)).all())

    recs = [r for s in sess.step_reports for r in s.records]
    n_steps = rep.n_steps
    row = {
        "phase": "full", "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "param_init_s": t_init, "run_s": t_run,
        "n_steps": n_steps, "n_tokens": rep.n_tokens,
        "tokens_per_s": rep.tokens_per_sec,
        "tokens_per_s_priced": rep.tokens_per_sec_priced,
        "plan_cache_hit_rate": rep.plan_cache_hit_rate,
        "pad_cache_hit_rate": rt._pad_cache.hit_rate,
        "pad_cache_hits": rt._pad_cache.hits,
        "pad_cache_misses": rt._pad_cache.misses,
        "gemms_per_step": len(first.records),
        "fleet_exec_s_per_step": sum(r.exec_time for r in recs) / n_steps,
        "step_wall_s": [s.wall_time for s in sess.step_reports],
        "all_verified": all(s.verified for s in sess.step_reports),
        "failed_ids": list(rep.failed_ids), "n_recovered": rep.n_recovered,
        "paged_read_checks": sess.paged_read_checks,
        "first_step_logits_rel_l2": rel_l2,
        "first_step_argmax_equal": argmax_eq,
        "launches": launches,
    }
    emit(row)
    check(row["all_verified"], "full width: a step failed verification")
    check(rep.failed_ids == (3,) and rep.n_recovered > 0,
          "full width: the failure did not fire or recovered nothing")
    check(sess.paged_read_checks == n_steps, "full width: paged read "
          f"checks {sess.paged_read_checks} != steps {n_steps}")
    # both paths round each GEMM output to bf16 after f32 sums taken in
    # another order; a flipped last bit (2^-8 relative) now and then,
    # carried through 4 layers, stays well under 2% of the logits' norm
    check(rel_l2 <= 2e-2, f"full width: first-step logits rel L2 {rel_l2}")
    check(all(v > 0 for v in launches.values()),
          f"full width: a kernel was not launched: {launches}")

    # one full-width GEMM with a poisoning device, under the f32 policy:
    # under bf16 the tolerance (32 x 7.8e-3 x sqrt(n / area) of sum |C|)
    # rightly swamps a single-entry poison of size 1 + |C00|
    m, n, q = slots, cfg.d_model, cfg.d_ff
    A = torch.randn((m, n), generator=gen, device=dev)
    B = torch.randn((n, q), generator=gen, device=dev) / n ** 0.5
    g = cm.GEMM(m=m, n=n, q=q, b=4)
    owners = {a.device_id for a in rt.plan_gemm(g).assignments}
    check(5 in owners, f"device 5 owns no rectangle of {g}: {owners}")
    st = rt.execute_step(A, B, gemm=g, corrupt_ids=[5], backend="torch",
                         dtype_policy="f32")
    want = torch.matmul(A, B)
    err = float((st.output - want).abs().max() / want.abs().max())
    emit({"phase": "full_corrupt", "m": m, "n": n, "q": q,
          "verified": st.verified, "n_tasks": st.n_tasks,
          "corrected_rel_err": err, "exec_time_s": st.exec_time})
    check(not st.verified, "poisoned GEMM passed verification")
    check(err <= 1e-5, f"poisoned GEMM not corrected: rel err {err}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    full = dataclasses.replace(get_config("llama3-8b"), n_layers=4)

    if "build" in phases:
        phase_build()
    gemm = phase_gemm(full) if "gemm" in phases else None
    paged = phase_paged() if "paged" in phases else None
    if "reduced" in phases:
        phase_reduced()
    launches = phase_full(full) if "full" in phases else None

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if gemm and paged and launches:
        kernels = [
            {"name": "band_gemm", "route": "cuda",
             "source": "src/repro_torch/csrc/band_gemm.cu",
             "replaces": "src/repro/kernels/block_gemm.py:59",
             "launches": launches["band_gemm"],
             "max_abs_err": gemm["max_abs_err"], "ms": gemm["ms"],
             "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
             "bound_by": gemm["bound_by"],
             "library_ms": gemm["library_ms"]},
            {"name": "paged_decode", "route": "cuda",
             "source": "src/repro_torch/csrc/paged_decode.cu",
             "replaces": "src/repro/kernels/decode_attention.py:97",
             "launches": launches["paged_decode"],
             "max_abs_err": paged["max_abs_err"], "ms": paged["kernel_ms"],
             "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
             "bound_by": paged["bound_by"], "library_ms": None},
        ]
        emit({"kernels": kernels})
    print(smi.splitlines()[0], flush=True)
    if set(phases) == set(PHASES):
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
