"""Batched serving driver of the port: prefill a batch of prompts, then
greedy- or temperature-decode with the KV cache (RWKV: the recurrent states
the prefill leaves), on ``--device`` (the card by default).

``--edge-plan N`` also drives the fleet decode path: the same prompts run
through ``TorchCleaveRuntime.serve_session`` -- paged KV on the device,
every projection GEMM executed on an N-device edge fleet through the band
GEMM kernel -- and the driver prints the planner's projection, measured
and engine-priced per-token latency, and whether the greedy tokens match
the monolithic decode.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --batch 4 --prompt-len 16 --gen 32 [--kv-int8] [--edge-plan 16]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --no-reduced --layers 4 --batch 4 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-1b-a400m --no-reduced --layers 4 --edge-plan 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --no-reduced --layers 1 --edge-plan 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-vl-72b --no-reduced --layers 3 --edge-plan 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-medium --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch hymba-1.5b --no-reduced
  (``--no-reduced --layers 4`` runs full width at 4 layers;
  ``--device cpu`` runs the plain CPU path.)

The encoder-decoder (seamless-m4t-medium) prefills with 2 * prompt-len
random encoder frames (the stubbed audio frontend), then decodes against
the cross K/V that ``encdec.prepare_cross_cache`` computes from them, as
the reference's driver does (``encdec.decode_cache``); its states are not
paged, so ``--edge-plan`` raises the reference's ValueError.  So does the
hybrid's (hymba-1.5b), whose decode cache is built as the reference's
driver builds it: the prompt's K/V from the prefill, the SSM state from
zeros (the reference's prefill does not return it; ROADMAP C).
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def prefill_cache(cfg, params, prompts, cache_len, *, kv_quant=False):
    """The decode set-up of the reference's ``launch/serve.py`` for a
    decoder-only model: one
    ``prefill`` of ``prompts`` (B,P), then a cache of ``cache_len`` slots
    holding the prompt's K/V (MLA: ckv/kpe; RWKV: the recurrent states)
    at the prompt's position.  With ``kv_quant`` the int8 cache stays
    empty (the caller feeds the prompt token by token).  Returns (the
    prompt's last logits, the cache)."""
    from repro_torch.models import model as M
    logits, pre = M.prefill(cfg, params, {"tokens": prompts})
    P = prompts.shape[1]
    cache = M.init_cache(cfg, prompts.shape[0], cache_len, kv_quant=kv_quant,
                         device=prompts.device)
    for nm in ("wkv_state", "tm_prev", "cm_prev"):
        if nm in pre:              # RWKV: the prompt's recurrent states
            cache[nm] = pre[nm]
    if not kv_quant:
        for nm in ("k", "v", "ckv", "kpe"):
            if nm in cache:
                cache[nm][:, :, :P] = pre[nm].to(cache[nm].dtype)
        cache["pos"] = pre["pos"]
    return logits, cache


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default; --no-reduced for "
                         "full size)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override the config's depth (0 keeps it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--edge-plan", type=int, default=0, metavar="N",
                    help="plan AND execute the decode through an N-device "
                         "edge fleet (TorchCleaveRuntime.serve_session)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="edge path: tokens per KV page")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    if cfg.enc_dec:
        from repro_torch.models import encdec
        feats = torch.randn((B, 2 * P, cfg.d_model), generator=gen,
                            device=dev)
        logits, cache = encdec.decode_cache(cfg, params, prompts, feats,
                                            P + G, kv_quant=args.kv_int8)
    else:
        logits, cache = prefill_cache(cfg, params, prompts, P + G,
                                      kv_quant=args.kv_int8)
    sync()
    t_prefill = time.perf_counter() - t0
    if args.kv_int8:
        # re-ingest the prompt token by token (int8 writes)
        cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
        for t in range(P):
            logits, cache = M.decode_step(cfg, params, cache,
                                          prompts[:, t:t + 1])

    def sample(lg):
        lg = lg[:, -1, :cfg.vocab_size]
        if args.temperature <= 0:
            return torch.argmax(lg, dim=-1)[:, None]
        probs = torch.softmax(lg / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    tok = sample(logits)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(G - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok)
        tok = sample(logits)
        out.append(tok)
    sync()
    dt = (time.perf_counter() - t0) / max(G - 1, 1)
    gen_toks = torch.cat(out, dim=1).cpu().numpy()
    print(f"arch={cfg.name} layers={cfg.n_layers} device={dev} "
          f"prefill={t_prefill * 1000:.0f}ms decode={dt * 1000:.1f}ms/tok "
          f"kv_int8={args.kv_int8}")
    for b in range(min(B, 2)):
        print(f"  req{b}: {gen_toks[b, :24].tolist()}")

    if args.edge_plan > 0:
        from repro_torch.api import Fleet, PlanRequest, TorchCleaveRuntime
        rt = TorchCleaveRuntime(arch=cfg,
                                fleet=Fleet.sample(args.edge_plan,
                                                   seed=args.seed),
                                accounting="broadcast", device=dev)
        rep = rt.plan(request=PlanRequest(batch=B, seq=P + G,
                                          backward=False))
        print(f"edge serve plan ({args.edge_plan} devices): "
              f"batch_time={rep.batch_time:.1f}s "
              f"comm/dev={rep.per_device_comm / 1e6:.0f}MB "
              f"mem/dev={rep.per_device_mem / 1e6:.0f}MB")
        sess = rt.serve_session(params, slots=B, page_size=args.page_size,
                                max_len=P + G, kv_int8=args.kv_int8,
                                seed=args.seed)
        pn = prompts.cpu().numpy().astype(np.int32)
        for b in range(B):
            sess.submit(pn[b], max_new=G)
        srep = sess.run()
        print(f"edge serve executed: {srep.n_tokens} toks in "
              f"{srep.n_steps} steps | measured "
              f"{srep.wall_time / max(srep.n_tokens, 1) * 1e3:.1f}ms/tok "
              f"({srep.tokens_per_sec:.1f} tok/s) | predicted "
              f"{srep.virtual_time / max(srep.n_tokens, 1) * 1e3:.1f}ms/tok "
              f"({srep.tokens_per_sec_priced:.1f} tok/s) | plan cache "
              f"{srep.plan_cache_hit_rate:.0%}")
        if args.temperature <= 0:
            fleet_toks = [r.tokens for r in sess.batcher.finished]
            mono_toks = [gen_toks[b, :G].tolist() for b in range(B)]
            match = sorted(map(tuple, fleet_toks)) \
                == sorted(map(tuple, mono_toks))
            print(f"  greedy tokens match monolithic: {match}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
