#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing JSON lines; any failed check exits non-zero:

1. build   -- compile every CUDA kernel from ``src/repro_torch/csrc``
              (one ``nvcc`` per source, all started together).
2. gemm    -- the band GEMM kernel against its plain version at the decode
              shapes of llama3-8b, at bucket shapes of its forward, dA
              and dW training GEMMs, and off the tile grid and off TMA's
              8-element alignment (bf16 on the wgmma/TMA body, and IEEE f32
              with TF32 off on the FMA body; each call counted on its
              body, the bf16 ones with their aligned copies); two
              launches of each split-K shape, bf16 and f32, bitwise equal;
              the decode shapes timed beside the plain version, one
              ``torch.matmul`` and their bound.
3. paged   -- the paged decode kernel (B3) against its plain version cut
              at the same splits (shuffled page tables, ragged lengths, a
              length-0 request) at llama's and granite's serving shapes,
              a 32k context (f32 and bf16) and its pages of 64 and 256,
              and two cases off the fast route's rule (the element route,
              its launches counted); two launches bit for bit; timed at
              the serving shapes and the 32k context by events and with
              the host's gaps hidden, beside the bound, the plain version
              and the flash-decode kernel (B5) on the same tokens.
4. flash   -- the flash-attention kernel against its plain version at the
              training shape, a serving prefill, a sliding window, a
              wide GQA case and a head dim off the kernel's grid, and at
              MLA's q/k wider than v (deepseek-v2-236b's training shape
              and a prefill at Dk 192, Dv 128, a window, the reduced 48 /
              32), and at seamless-m4t-medium's (D 64, G 1: the
              bidirectional encoder, the causal decoder, the
              cross-attention over Sk = 2 Sq, a prefill's), and at
              hymba-1.5b's (G 5, D 64, causal after 128 meta keys, so at
              q_offset 128: the training step's and a prefill's; the meta
              keys always visible under windows of 64 and 2048), in f32
              and bf16, two launches bit for bit; timed at llama's
              training shape (f32), MLA's (f32 and bf16), seamless's
              cross-attention (bf16) and hymba's training shape (f32 and
              bf16)
              beside the plain version and
              ``scaled_dot_product_attention`` (or its refusal), also
              with the host's gaps hidden.
5. decode  -- the contiguous-cache flash-decode kernel against its plain
              version (and, in f32, the reference's ``decode_attention``)
              at the serving shape, with ragged per-request lengths, an
              8-group GQA case, a 32k-token cache, granite's serving
              shape, seamless's cross-attention over 32 all-valid
              encoder slots and hymba's decode over [128 meta tokens; a
              cache of 32] at G 5, in f32 and bf16, two launches bit for
              bit, every launch on the cp.async route; timed at llama's,
              granite's, seamless's and hymba's serving shapes and the
              32k cache,
              in f32 and bf16,
              by events and with the host's gaps hidden, beside the plain
              version, ``scaled_dot_product_attention`` with
              ``enable_gqa`` on the unrepeated caches (its device time
              too, and on caches repeated G times beforehand) and the
              bound.
6. wkv     -- the WKV-6 kernel against its plain version at the RWKV
              training shape (zero and random incoming state), a prompt
              length off the 32-step chunk grid and S = 1, y and the last
              state, two launches bit for bit; against the step-exact
              recurrence at a small shape; timed (bf16, by events and with
              the host's gaps hidden) at the training, decode and
              100-token prefill shapes beside the bound, the training
              shape beside the plain version.
7. reduced -- ``llama3-8b.reduced()`` fleet serving under the f32 policy
              with a device failure: greedy tokens equal the port's
              monolithic decode, every step verified, tasks recovered.
8. full    -- serving at full width: llama3-8b (4 layers, bf16), 4 slots,
              through four kernels (the prefills run flash attention, every
              decode step's attention the flash-decode kernel) with a
              device failure at step 2 and the paged read checked every
              step (one paged decode launch a step, on the fast route);
              launch counts read around this run.  Then one
              full-width GEMM with a poisoning device must be caught and
              corrected.
9. train_reduced -- fleet training of ``llama3-8b.reduced()`` under the f32
              policy for 3 steps with a mid-backward failure, against the
              monolithic step: loss, grad_norm and moments within 1e-4
              relative, params within 2e-5 in L2, which the same run
              under the bf16 policy must fail; every band GEMM launch
              (f32) held against the plain version on its own operands
              and counted on the FMA body; the first step's launch set
              timed (as in rwkv_reduced and moe_reduced).
10. train_full -- the training path at full width: llama3-8b (4 layers,
              bf16 params and policy), batch 8 x 128, 16-device fleet, 3
              fleet steps (forward, dA and dW GEMMs on the band GEMM
              kernel, attention on the flash kernel) with a failure at
              step 1, then a fourth step in which every band GEMM launch
              is held against the plain version on its own operands;
              launch counts read around these steps; the first step's
              loss and grad_norm against the monolithic path; the first
              step's set of band GEMM launches timed beside its bound.
11. rwkv_reduced -- fleet training of ``rwkv6-7b.reduced()`` under the f32
              policy for 3 steps with a device failure mid-step, against
              the monolithic step (loss, grad_norm, moments within 1e-4,
              params in L2 beside a bf16-policy control); then greedy
              prefill + 8 decode steps against token-by-token decoding.
12. rwkv_full -- rwkv6-7b at full width (4 layers, bf16), batch 8 x 128,
              16-device fleet: 3 fleet steps (the LM head's GEMMs on the
              fleet, the time mix on the WKV kernel) with a failure at step
              1, the first step against the monolithic path; then prefill
              of 4 prompts of 16 and 8 decode steps, the first decode
              step's logits against token-by-token decoding; WKV launch
              counts read around training, prefill and decode.
13. bgemm  -- the batched block GEMM (the MoE experts' products) against
              its plain version, f32 and bf16, at every shape of a
              full-width granite-moe-1b-a400m training step (forward, dA,
              dW) and decode step, at two ragged G > 1 shapes (one off
              TMA's alignment), and the plain block GEMM at the kernels
              benchmark's 512^3; each timed beside its plain version, one
              ``torch.bmm`` / ``torch.matmul`` and its bound, and the
              training and decode steps' launch sets summed; the decode
              step's products also as it runs them (f32 A against the
              bf16 weights as stored, bitwise equal to the launch on an
              f32 copy), beside ``torch.bmm`` in f32.
14. moe_reduced -- fleet training of ``granite-moe-1b-a400m.reduced()``
              under the f32 policy for 3 steps with a device failure
              mid-backward, against the monolithic step (loss, grad_norm,
              moments within 1e-4, params in L2 beside a bf16-policy
              control); then fleet serving against token-by-token
              monolithic decoding, tokens identical (capacity factor 32).
15. moe_full -- granite-moe-1b-a400m at full width (4 layers, bf16), batch
              8 x 128, 16-device fleet: 3 fleet steps (attention
              projections, router and LM head on the band GEMM, the
              experts on the batched block GEMM) with a failure in step
              1's backward, the first step against the monolithic path with
              the share of routing choices that differ; then serving, 4
              slots, a failure at step 2, the paged read checked every
              step, the first decode step against the monolithic
              ``decode_step``; batched block GEMM launches counted around
              both, each held against the plain version; every decode
              step's expert product reads the bf16 weights as stored (f32
              x bf16, no promoted copy), bitwise equal to the launch on
              an f32 copy.
16. mla_reduced -- fleet training of ``deepseek-v2-236b.reduced()`` under
              the f32 policy for 3 steps with a device failure
              mid-backward, against the monolithic step (loss, aux loss,
              grad_norm, moments within 1e-4, params in L2 beside a
              bf16-policy control; flash attention at Dk 48, Dv 32); then
              fleet serving from the latent ckv/kpe pools against
              token-by-token monolithic decoding, tokens identical
              (capacity factor 32).
17. mla_full -- deepseek-v2-236b at full width (1 layer, bf16: 5.0 B
              params, 60 GB with grads and moments), batch 8 x 128,
              16-device fleet: 3 fleet steps with the params and moments
              updated in place (``donate=True``), a failure in step 1's
              backward, the first step against the monolithic path with
              the share of routing choices that differ, the peak memory;
              the first step's band GEMM and batched block GEMM (160
              experts) launch sets held against their plain versions on
              fresh operands and timed; then serving from the latent
              pools, 4 slots, a failure at step 2, the paged read asked
              for and skipped as the reference skips it (no paged decode
              launch), the first decode step against the monolithic
              ``decode_step`` given the session's routing; every serving
              block GEMM launch held against the plain version.
18. mrope_reduced -- fleet training of ``qwen2-vl-72b.reduced()`` under
              the f32 policy for 3 steps on batches with 8 patch
              embeddings a row on a 2 x 4 M-RoPE grid, device 2 failing
              in step 1's backward, against the monolithic step (loss,
              grad_norm, moments within 1e-4, params in L2 beside a
              bf16-policy control, 48 fleet GEMMs a step); then fleet
              serving (M-RoPE decode positions, the paged read checked
              every step) against token-by-token monolithic decoding,
              tokens identical.
19. mrope_full -- qwen2-vl-72b at full width (3 layers, bf16: 5.12 B
              params, 61.5 GB with grads and moments), batch 8 x 128 with
              32 patch embeddings a row on a 4 x 8 grid, 16-device fleet:
              3 fleet steps updating params and moments in place, a
              failure in step 1's backward, the first step against the
              monolithic path, the peak memory; the first step's band
              GEMM launch set held against the plain version on fresh
              operands (against an f64 product where the plain version's
              own f32 sums drift) and timed; then serving, 4 slots,
              prompts of 16, 8 new tokens, pages of 16, a failure at step
              2, the paged read checked every step (B3), the first decode
              step against the monolithic ``decode_step``.
20. encdec_reduced -- as mrope_reduced for
              ``seamless-m4t-medium.reduced()``: 64 encoder frames a row,
              130 fleet GEMMs a step (the encoder's recompute and the
              discarded projections the reference runs); then the
              monolithic serving path (the cross cache, a prefill, decode
              steps against it) against a forward over the prompt and
              token-by-token decoding.
21. encdec_full -- seamless-m4t-medium at full depth (12 + 12 layers,
              bf16, 0.98 B params), batch 8 x 128 with 256 encoder frames
              a row: 3 fleet steps (750 GEMMs each), a failure in step 1's
              backward, the first step against the monolithic path, the
              peak memory, the first step's band GEMM set held against
              the plain version and timed; then 4 prompts of 16 over 32
              encoder frames, 8 greedy tokens on the monolithic path
              (flash attention non-causal at Sk = 2 Sq, B5 over the
              all-valid cross cache), the first decode step against a
              forward over the prompt and the first new token.
22. hymba_reduced -- as mrope_reduced for ``hymba-1.5b.reduced()`` (the
              SSM heads' projections and scan on the PS, 16 fleet GEMMs of
              each kind a step); then the monolithic serving path as
              ``launch/serve.py`` runs it (a prefill that leaves the SSM
              state at zero, as the reference's does, then decode steps,
              B5 over [meta tokens; cache]) and token-by-token decoding of
              the prompt and the first new token against a forward.
23. hymba_full -- hymba-1.5b at full depth (32 layers, bf16, 1.64 B
              params), batch 8 x 128: the first step's monolithic loss and
              grad_norm, 3 fleet steps (226 GEMMs of each kind) updating
              params and moments in place, a failure in step 1's
              backward, the peak memory beside the predicted one, one
              more step's device time and idle share under the profiler
              (mrope_full and encdec_full report theirs too), the first
              step's band GEMM set held against the plain version and
              timed; then 4 prompts of 16, 8 greedy tokens on the
              monolithic path (B4 over [128 meta keys; prompt] at
              q_offset 128, B5 over [meta; cache] at G 5), and
              token-by-token decoding of the prompt and the first new
              token against a forward.
24. multips_reduced -- multi-PS training of ``llama3-8b.reduced()`` under
              the f32 policy (8 devices, B 2 x S 32): K=1/H=1 bit-equal
              to the single-PS session over 2 steps (loss, params, mu,
              nu); K=2/H=2 (islands of 4) on two data shards, the
              replicas apart after step 1 and bit-equal after the round,
              the sync volume 2 x the shards' bytes, the sharded round
              bit-equal to the monolithic ``outer_step``, the first step's
              band GEMM launches held against the plain version; the same
              run updated in place bit-equal to it; the round-boundary
              checkpoint restored into a fresh session bit for bit, one
              resumed step equal to the uninterrupted one, a bf16 copy of
              the state through save and restore; PS 1 failing mid-round
              (its 4 devices join island 0 with their ids); a device
              failing inside island 1, recovered.
25. multips_full -- llama3-8b at full width (4 layers, bf16), 16 devices
              in 2 islands of 8, K=2, H=2, batch 8 x 128 an island from
              two data seeds, params, moments and the outer round in
              place: a failure in island 1's backward (step 1), the round
              (step 2: replicas bit-equal, the sync bytes), PS 1 failing
              (step 3), the survivor over 16 devices (step 4); island 0's
              first step against the monolithic path (loss 1e-2,
              grad_norm 5e-2) and its band GEMM set against the plain
              version; the step walls, the round's device time beside
              its bound, the peak memory beside the prediction.
26. batch  -- ``execute_batch(8, 128)`` of llama3-8b (4 layers) on 16
              devices, torch backend under the f32 policy, the whole DAG
              (87 GEMMs, operands drawn on the card): level and dataflow
              dispatch bit-equal, with the same band GEMM launches; the
              first two levels within 1e-5 of the numpy backend's f64
              products; a failing device within 1e-5 of the clean run; a
              poisoning device caught by the deferred Freivalds checks,
              every output within 1e-5 of the clean run but for
              injections the f32 policy's tolerance passes (counted,
              each passed again by the same acceptance test on f64
              residuals with the step's own probes); each walk's wall,
              predictions, launches and ``PadCache`` hit rate.
27. sim    -- the paper's cost model on the card's host (numpy; no tensor,
              no kernel): ``TorchCleaveRuntime.simulate`` for llama3-8b at
              full width and depth (32 layers), B 8 x S 128 on
              ``Fleet.sample(16, seed=0)`` and B 128 x S 1024 on 512
              devices, on the analytic, event and event-array backends
              (the event replay within 1e-6 of the closed form; the array
              engine within 1e-9 of the scalar one, also under a
              fail/join/slowdown script whose failure lands mid-work:
              makespan, level times, recovery latency, which must be
              positive on both); ``stream_profile`` of its d_ff GEMM under
              Pareto(2) jitter; ``compare_systems("llama2-13b", 128,
              1024, 512)`` (Table 8's row); ``ArrayTimelineEngine
              .add_chains_bulk`` at 10,000 devices (the reference's core
              bench row), its events/s and wall beside the host's CPU.
28. examples -- every ``examples_torch/*.py`` ``main`` on the card at the
              reference's sizes (``train_e2e`` at ``scripts/check_docs.py``'s
              smoke arguments, monolithic and on the fleet with a
              failure; ``serve_decode`` also under the f32 policy):
              torch-backend outputs within 1e-5 of the f64 product
              (relative to its largest value) and verified, tasks
              recovered where a failure fires, warm steps after churn on
              cached plans, the six served requests drained (under f32
              their tokens equal to token-by-token monolithic decoding),
              the multi-PS rounds with both islands alive; every band
              GEMM, flash-attention, flash-decode and paged-decode launch
              held against its plain version on the same inputs (1e-5 of
              the largest output in f32, one bf16 ulp in bf16), the
              counts checked equal to the launches; B1, B3, B4, B5 (and
              the other kernels') launches counted around each run, the
              totals in the kernels line as ``launches_examples``.
29. mesh_reduced -- the mesh layer on four ranks sharing the card (the
              threaded process group: gloo's processes crash on CUDA
              tensors there): the CLEAVE-sharded train step against the
              single-device one for llama3-8b and granite-moe-1b-a400m on
              2x2 and on the pod axis 2x1x2 (``launch.mesh_check``; the
              script's tolerances, and 1e-5 where the MoE capacity does
              not bind), the sharded MoE against the global path on the
              same tokens without drops, the sharded flash-decode against
              the unsharded decode, and prefill then serve under decode
              rules against the unsharded port (greedy tokens equal);
              the eight other families on 2x2 against single-device
              (loss and a decode step's logits 1e-5, gradients 1e-4 in
              relative L2); every
              B2, B4 and B5 launch held against its plain version, the
              counts checked equal to the launches.
30. mesh_full -- ``launch.dryrun`` for rank 0 at full width on the
              production meshes, in a fake process group of the mesh's
              world size (collectives move no data, so the launches'
              data mean nothing: each launch's signature, its operands'
              layouts and mask flags, is recorded, and every signature
              is then held to its plain version on fresh inputs, 1e-5
              in f32, 2^-7 in bf16; B5 must not launch): llama3-8b
              train_4k and decode_32k on 16x16, granite-moe-1b-a400m
              train_4k on 2x16x16, deepseek-v2-236b train_4k on 16x16
              (16 of 60 layers, its 16 microbatches kept); per case the
              peak of ``torch.cuda.max_memory_allocated``, ``fits_hbm``,
              FLOPs, collective bytes by kind, the roofline terms, the
              step's ms by CUDA events, the card's busy ms and idle
              share under ``torch.profiler``, and the B2, B4 and B5
              launches.
31. freivalds -- the fused Freivalds residual kernel against its plain
              version at the benchmark cell's own buckets (deepseek-v2-236b
              on ``Fleet.sample(16, seed=0, phone_fraction=0.6)``): the LM
              head's dW (one band of 5,120 rows, 16 rectangles), ``wo``'s dW
              (5 buckets), the router's forward (16 single-rectangle
              bands), the LM head's forward and dA, each through ``ops.plan_gemm_buckets`` in bf16 and
              f32 with a third of the rectangles poisoned: every number
              within 1e-5 of the absolute sum of its terms, the poisoned
              band products identical, the verdicts of the executor's
              acceptance test equal to the plain version's with no clean
              rectangle flagged (and, in f32, every poisoned one), one
              call a bucket; the kernel's signs against ``ops.rademacher``
              bit for bit, read through its residuals (``sign_probe``:
              band products of powers of two on zero operands, at the
              first, middle and last rows and columns of every
              rectangle); each GEMM's buckets timed with the host's gaps
              hidden beside their bound (A and B once in their type, C
              once in f32) and the plain version.  Every fleet phase
              holds each step's fused residual launches to the verified
              buckets the executor ran on the card and to the step's
              ``fleet.residual_launches`` counter (``residual_since``);
              the ``kernels`` line reads those main paths' counts.

In ``full``, ``train_full``, ``rwkv_full``, ``moe_full``, ``mla_full``,
``mrope_full``, ``encdec_full``, ``hymba_full`` and ``multips_full`` every
bf16 launch of the block GEMMs must have run the wgmma/TMA body
(``block_gemm.tc_launches``) with no aligned copy, and every f32 one the
FMA body (``block_gemm.fma_launches``); in the f32-policy cells and
``multips_reduced`` every launch ran the body its type picks.

Then a ``kernels`` line, the card's name and power limit as
``nvidia-smi`` gives them, and the result line.  ``--phases`` runs a
subset (for bring-up); the result line needs all of them.

Three more phases run only when named.  ``--phases build,split``: the
flash-decode kernel at split sizes of 256 to 4096 slots (the 32k cell, a
4k-token cache, llama's and granite's serving shapes) beside the split
rule's own (``decode_splits``); the paged decode kernel at split sizes of
1024 to 4096 tokens at the paged 32k cell beside its rule's own
(``paged_splits``); the band GEMM's bf16 body at each split count of the
contraction,
for the decode products of llama3-8b and granite-moe-1b-a400m, the LM
head's training dA and a product that fills the card, each split held
against the unsplit result and timed with the host's gaps hidden, beside
the split rule's own count (``block_gemm.split_plan``) and
``torch.matmul``; the f32 body at each tiling and split count for 512^3,
the MoE decode products (f32 A, bf16 B), f32-policy cells' buckets and
two full-width f32 buckets, beside the rule's pick
(``block_gemm.fma_plan``); flash attention's block shapes (32, 64 and 128
rows) at llama's training shape (f32).  ``--phases build,f32sets``: the f32 kernels' sets as the paths
run them, through calls every tree of the port offers.  ``--phases
build,attnsets``: the flash-decode kernel at the decode phase's timed
shapes, the WKV kernel at its and the paged decode kernel at the paged
phase's, likewise through calls every tree offers
(``ops.gqa_flash_decode``, ``ops.wkv6``, ``ops.gqa_flash_decode_paged``).  With ``--src DIR`` the
script imports ``repro_torch`` from DIR (the ``src`` of another tree,
e.g. the parent unpacked with ``git archive`` into the ignored
``build/``), which builds its own sources, so two trees are timed in one
call (``f32sets``, ``attnsets``).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("build", "gemm", "paged", "flash", "decode", "wkv", "reduced",
          "full", "train_reduced", "train_full", "rwkv_reduced", "rwkv_full",
          "bgemm", "moe_reduced", "moe_full", "mla_reduced", "mla_full",
          "mrope_reduced", "mrope_full", "encdec_reduced", "encdec_full",
          "hymba_reduced", "hymba_full", "multips_reduced", "multips_full",
          "batch", "sim", "examples", "mesh_reduced", "mesh_full",
          "freivalds")
EXTRA_PHASES = ("split", "f32sets", "attnsets")   # run only when named
# one H100 SXM, dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BW = 3.35e12                 # bytes/s
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # FLOP/s, f32 off-core
# train_reduced: per-leaf relative L2 distance of the fleet's params from
# the monolithic step's after 3 steps (f32 policy)
TRAIN_PARAMS_L2_LIMIT = 2e-5
# clock cycles of sleep per timed call that cover the host's enqueue of it
# (about 0.3 ms at the H100's clock; a wrapper call takes under 0.1 ms)
HOST_COVER_CYCLES = 600_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BW * 1e3
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, iters: int = 10, reps: int = 5,
            hide_host: bool = False, launches: int = 1) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls,
    after warm-up (CUDA events).  The events bracket the host's gaps
    between calls too, which a call of a few microseconds of device work
    can exceed; with ``hide_host`` a sleep kernel ahead of the start event
    keeps the card busy while the host enqueues the calls (``fn`` makes
    ``launches`` wrapper calls), so the events bracket the calls' device
    time alone."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(HOST_COVER_CYCLES * iters * launches)
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


# the verified band buckets the executor ran on the card (calls of
# ops._bucket_gemm_verified with CUDA operands, counted by residual_mark's
# wrapper), and the fused residual kernel's launches by phase
VERIFIED_BUCKETS = {"card": 0}
RESIDUALS_BY_PHASE: dict = {}


def residual_mark() -> tuple:
    """(fused residual launches, verified card buckets) so far, for
    :func:`residual_since`; counts the buckets from the first call on."""
    from repro_torch.kernels import freivalds as fv
    from repro_torch.kernels import ops
    real = ops._bucket_gemm_verified
    if not getattr(real, "counted", False):
        def counted(a_pad, *args, **kw):
            if a_pad.device.type == "cuda":
                VERIFIED_BUCKETS["card"] += 1
            return real(a_pad, *args, **kw)
        counted.counted = True
        ops._bucket_gemm_verified = counted
    return fv.launches, VERIFIED_BUCKETS["card"]


def residual_since(mark: tuple, phase: str, report=None) -> dict:
    """The fused residual kernel's launches and the verified buckets run on
    the card since ``mark``, added to the phase's total: one launch a
    bucket; where a training step's report (or its islands' reports) is
    given, some launches, and its ``fleet.residual_launches`` counter the
    same."""
    from repro_torch.kernels import freivalds as fv
    n, b = fv.launches - mark[0], VERIFIED_BUCKETS["card"] - mark[1]
    check(n == b, f"{phase}: {n} fused residual launches for {b} verified "
          "buckets on the card")
    out = {"freivalds_launches": n, "verified_buckets": b}
    if report is not None:
        reps = report if isinstance(report, (list, tuple)) else [report]
        c = sum(r.counters.get("fleet.residual_launches", 0) for r in reps)
        check(n > 0 and c == n, f"{phase}: the step counts {c} residual "
              f"launches, the kernel ran {n}")
    RESIDUALS_BY_PHASE[phase] = RESIDUALS_BY_PHASE.get(phase, 0) + n
    return out


BLOCK_GEMM_COUNTERS = ("launches", "batched_launches", "block_gemm_launches",
                       "tc_launches", "fma_launches", "split_launches",
                       "fma_split_launches", "aligned_copies")


@contextlib.contextmanager
def band_gemm_audit(verify: bool, entry: str = "block_gemm_batched_shared"):
    """Wraps a block GEMM wrapper (``entry`` of ``kernels.block_gemm``: the
    band GEMM, or ``block_gemm_batched``) while a path runs.  Records every
    launch's operand shapes and type and, with ``verify``, holds each
    result against the plain version on the same operands (relative
    1e-5 of the largest output: both sides sum exact products in f32, in
    another order).  The plain calls launch no kernel, so they add
    nothing to the launch count.  ``by_dtype`` counts the launches by A's
    type, ``mixed`` those of an f32 A against a bf16 B; ``by_body`` counts
    them by the body each launched, from the wrapper's per-body counters
    around each call.  With ``verify`` a mixed launch must also equal, bit
    for bit, the launch on B converted to f32, whose launch the counters
    then forget."""
    import torch
    from repro_torch.kernels import block_gemm as bg
    real, plain = getattr(bg, entry), getattr(bg, entry + "_plain")
    audit = {"shapes": [], "checked": 0, "max_abs_err": 0.0,
             "max_rel_err": 0.0, "by_dtype": collections.Counter(),
             "by_body": collections.Counter(), "mixed": 0,
             "mixed_bitwise_equal_promoted": 0}

    def audited(a, b):
        n_tc, n_fma = bg.tc_launches, bg.fma_launches
        c = real(a, b)
        audit["by_body"]["wgmma_bf16"] += bg.tc_launches - n_tc
        audit["by_body"]["fma_f32"] += bg.fma_launches - n_fma
        dt = str(a.dtype).rsplit(".", 1)[-1]
        audit["shapes"].append((tuple(a.shape), tuple(b.shape), dt))
        audit["by_dtype"][dt] += 1
        mixed = a.dtype != b.dtype
        audit["mixed"] += mixed
        if verify and mixed:
            saved = {n: getattr(bg, n) for n in BLOCK_GEMM_COUNTERS}
            promoted = real(a, b.float())
            for n, v in saved.items():
                setattr(bg, n, v)
            check(torch.equal(c, promoted), f"{entry} launch "
                  f"{audit['shapes'][-1]}: f32 x bf16 differs from the "
                  "launch on the f32 copy of B")
            audit["mixed_bitwise_equal_promoted"] += 1
            del promoted
        if verify:
            want = plain(a, b)
            err = float((c - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            if rel > 1e-5:
                # which side drifted: both against an f64 product
                exact = torch.matmul(a.double(), b.double())
                scale = float(exact.abs().max())
                check(False, f"{entry} launch {audit['shapes'][-1]}: rel "
                      f"err {rel:.3g} against the plain version (kernel "
                      f"{float((c - exact).abs().max()) / scale:.3g}, plain "
                      f"{float((want - exact).abs().max()) / scale:.3g} "
                      f"against f64)")
            audit["checked"] += 1
            audit["max_abs_err"] = max(audit["max_abs_err"], err)
            audit["max_rel_err"] = max(audit["max_rel_err"], rel)
            del want
        return c

    setattr(bg, entry, audited)
    try:
        yield audit
    finally:
        setattr(bg, entry, real)


ATTENTION_KERNELS = ("flash_attention", "flash_decode", "paged_decode")


@contextlib.contextmanager
def attention_audit():
    """Wraps the attention kernels' wrappers while a path runs -- flash
    attention (``attend``, which ``ops.mha_flash`` calls), flash decode and
    the paged decode -- and holds every launch's result against the plain
    version on the same inputs: within 1e-5 of the largest output in f32
    (sums in another order), one bf16 ulp of it (2^-7) in bf16 (both round
    p and the output to bf16).  The plain calls launch no kernel.  Per
    kernel: launches checked, the worst relative error, and the shapes
    checked with their counts."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    audit = {k: {"checked": 0, "max_rel_err": 0.0,
                 "shapes": collections.Counter()} for k in ATTENTION_KERNELS}
    real = {"flash_attention": fa.attend, "flash_decode": dec.flash_decode,
            "paged_decode": dec.flash_decode_paged}

    def hold(kernel, got, want, shape):
        scale = max(float(want.float().abs().max()), 1e-30)
        rel = float((got.float() - want.float()).abs().max()) / scale
        tol = 1e-5 if got.dtype == torch.float32 else BF16_OUT_TOL
        check(rel <= tol, f"{kernel} launch {shape}: rel err {rel:.3g} "
              f"against the plain version (limit {tol:g})")
        a = audit[kernel]
        a["checked"] += 1
        a["max_rel_err"] = max(a["max_rel_err"], rel)
        a["shapes"][shape] += 1

    def attend(q, k, v, out, *, causal=True, window=0, q_offset=0,
               prefix=0, _block_q=None):
        n = fa.launches
        real["flash_attention"](q, k, v, out, causal=causal, window=window,
                                q_offset=q_offset, prefix=prefix,
                                _block_q=_block_q)
        if fa.launches > n:
            with torch.no_grad():
                want = fa._attend_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        prefix=prefix)
            hold("flash_attention", out, want,
                 (tuple(q.shape), tuple(k.shape), tuple(v.shape),
                  bool(causal), int(window), int(q_offset), int(prefix),
                  str(q.dtype).rsplit(".", 1)[-1]))
        return out

    def flash_decode(q, k_cache, v_cache, valid, *, _split=None):
        n = dec.flash_decode_launches
        got = real["flash_decode"](q, k_cache, v_cache, valid, _split=_split)
        if dec.flash_decode_launches > n:
            with torch.no_grad():
                want = dec.flash_decode_plain(q, k_cache, v_cache, valid,
                                              split=_split)
            hold("flash_decode", got, want,
                 (tuple(q.shape), tuple(k_cache.shape),
                  str(k_cache.dtype).rsplit(".", 1)[-1]))
        return got

    def flash_decode_paged(q, k_pool, v_pool, page_table, lengths, *,
                           _split=None):
        n = dec.launches
        got = real["paged_decode"](q, k_pool, v_pool, page_table, lengths,
                                   _split=_split)
        if dec.launches > n:
            with torch.no_grad():
                want = dec.flash_decode_paged_plain(
                    q, k_pool, v_pool, page_table, lengths, split=_split)
            hold("paged_decode", got, want,
                 (tuple(q.shape), tuple(k_pool.shape),
                  tuple(page_table.shape),
                  str(k_pool.dtype).rsplit(".", 1)[-1]))
        return got

    fa.attend, dec.flash_decode = attend, flash_decode
    dec.flash_decode_paged = flash_decode_paged
    try:
        yield audit
    finally:
        fa.attend = real["flash_attention"]
        dec.flash_decode = real["flash_decode"]
        dec.flash_decode_paged = real["paged_decode"]


def time_band_gemm_set(shapes, entry: str = "block_gemm_batched_shared"):
    """Device time of a recorded set of block GEMM launches (``entry`` as in
    :func:`band_gemm_audit`): each distinct (A, B, type) timed once on
    fresh operands of its shape (kernel, plain version, one
    ``torch.matmul``, which is a batched product for a 3-d B; kernel and
    library also with the host's gaps hidden, ``device_ms``) and weighted
    by its count, beside the set's bound."""
    import torch
    from repro_torch.kernels import block_gemm as bg
    kernel, plain = getattr(bg, entry), getattr(bg, entry + "_plain")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tot = {"launches": len(shapes), "distinct": 0, "ms": 0.0,
           "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
           "library_device_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for (ash, bsh, dt), n in collections.Counter(shapes).items():
        dtype = getattr(torch, dt)
        G, m, k = ash
        q = bsh[-1]
        a = torch.randn(ash, generator=gen, device=dev).to(dtype)
        b = (torch.randn(bsh, generator=gen, device=dev) / k ** 0.5).to(dtype)
        tot["distinct"] += 1
        tot["ms"] += n * time_ms(lambda: kernel(a, b), iters=3, reps=3)
        tot["plain_ms"] += n * time_ms(lambda: plain(a, b), iters=3, reps=3)
        tot["library_ms"] += n * time_ms(lambda: torch.matmul(a, b),
                                         iters=3, reps=3)
        tot["device_ms"] += n * time_ms(lambda: kernel(a, b), iters=3,
                                        reps=3, hide_host=True)
        tot["library_device_ms"] += n * time_ms(
            lambda: torch.matmul(a, b), iters=3, reps=3, hide_host=True)
        esz = a.element_size()
        tot["bytes_ms"] += n * (esz * (a.numel() + b.numel())
                                + 4 * G * m * q) / PEAK_BW * 1e3
        tot["ops_ms"] += n * 2.0 * G * m * k * q / PEAK_OPS[dt] * 1e3
        del a, b
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    return tot


def reset_body_counts():
    """Zero the block GEMMs' per-body counters (``tc_launches`` of the bf16
    wgmma/TMA body, ``fma_launches`` of the f32 FMA body, their split
    launches, ``aligned_copies``)."""
    from repro_torch.kernels import block_gemm as bg
    bg.tc_launches = bg.fma_launches = bg.split_launches = 0
    bg.fma_split_launches = bg.aligned_copies = 0


def body_counts(*audits):
    """The launches the audits counted by body."""
    return {body: sum(a["by_body"][body] for a in audits)
            for body in ("wgmma_bf16", "fma_f32")}


def check_bodies(what: str, *audits):
    """Every launch the audits recorded ran the body its A's type picks
    (bf16: the wgmma/TMA body; f32, against an f32 or a bf16 B: the FMA
    body); returns the body counts."""
    counts = body_counts(*audits)
    by_type = {"wgmma_bf16": sum(a["by_dtype"]["bfloat16"] for a in audits),
               "fma_f32": sum(a["by_dtype"]["float32"] for a in audits)}
    check(counts == by_type,
          f"{what}: block GEMM launches by body {counts}, by type {by_type}")
    return counts


def check_bf16_body(what: str, *audits):
    """As :func:`check_bodies`, and the audits saw every launch of either
    body since :func:`reset_body_counts`, and none needed an aligned copy;
    returns the body counts."""
    from repro_torch.kernels import block_gemm as bg
    counts = {**check_bodies(what, *audits), "split_k": bg.split_launches,
              "fma_split_k": bg.fma_split_launches,
              "aligned_copies": bg.aligned_copies}
    check(counts["wgmma_bf16"] == bg.tc_launches
          and counts["fma_f32"] == bg.fma_launches
          and bg.aligned_copies == 0,
          f"{what}: body counts {counts}, counters {bg.tc_launches} "
          f"wgmma, {bg.fma_launches} FMA")
    return counts


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
                      "device_ms": 0.0, "library_device_ms": 0.0,
                      "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                      "max_abs_err": 0.0, "split_k_bitwise_repeats": 0}
    cases = [(1, 128, k, q, c) for k, q, c in decode_gemm_shapes(cfg)]
    # off the 128 tile grid; the last three also off TMA's 8-element
    # alignment (n 777 and 5: B is copied; k 999: A is)
    cases += [(3, 128, 4096, 4096, 0), (3, 100, 1000, 777, 0),
              (2, 100, 999, 130, 0), (1, 37, 77, 5, 0)]
    # buckets the 16-device plans give the training GEMMs at batch 8 x 128
    # (G bands of padded height m): forward, dA (the LM head's contracts
    # over the 128256-word vocabulary), and dW contracting over the 1024
    # (or, for the LM head's 64-token loss chunks, 512) tokens
    cases += [(1, 1024, 4096, 14336, 0), (2, 512, 14336, 4096, 0),
              (1, 512, 128256, 4096, 0), (4, 1920, 1024, 4096, 0),
              (1, 4096, 512, 128256, 0)]
    for G, m, k, q, per_step in cases:
        a32 = torch.randn((G, m, k), generator=gen, device=dev)
        b32 = torch.randn((k, q), generator=gen, device=dev) / k ** 0.5
        row = {"G": G, "m": m, "k": k, "n": q, "per_step": per_step}
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            a, b = a32.to(dt), b32.to(dt)
            n_tc, n_fma, n_cp = (bg.tc_launches, bg.fma_launches,
                                 bg.aligned_copies)
            got = bg.block_gemm_batched_shared(a, b)
            want = bg.block_gemm_batched_shared_plain(a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            # both sides sum exact products in f32; only the order differs
            check(rel <= 1e-5, f"band GEMM {name} {row}: rel err {rel:.3g}")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_rel_err"] = rel
            # the type alone picks the body; a misaligned bf16 operand is
            # copied once and the call still runs the wgmma/TMA body
            bf16 = dt == torch.bfloat16
            copies = sum(not bg.tma_ready(x) for x in (a, b)) if bf16 else 0
            check(bg.tc_launches - n_tc == bf16
                  and bg.fma_launches - n_fma == (not bf16)
                  and bg.aligned_copies - n_cp == copies,
                  f"band GEMM {name} {row}: {bg.tc_launches - n_tc} "
                  f"wgmma and {bg.fma_launches - n_fma} FMA launches, "
                  f"{bg.aligned_copies - n_cp} aligned copies (want "
                  f"{copies})")
            if bf16:
                row["aligned_copies"] = copies
                S = len(bg.split_plan(G, m, q, k)) - 1
            else:
                tiling, plan = bg.fma_plan(G, m, q, k)
                row["float32_tiling"], S = tiling, len(plan) - 1
            row[f"{name}_split_k_slices"] = S
            if S > 1:
                # no atomics: a second launch gives the same bits
                again = bg.block_gemm_batched_shared(a, b)
                row[f"{name}_split_k_bitwise_repeat"] = bool(
                    torch.equal(got, again))
                check(torch.equal(got, again),
                      f"band GEMM {name} split-K {row}: two launches differ")
                step["split_k_bitwise_repeats"] += 1
                del again
        if per_step or G == 3 and m == 128:
            a, b = a32.bfloat16(), b32.bfloat16()
            row["kernel_ms"] = time_ms(
                lambda: bg.block_gemm_batched_shared(a, b))
            row["plain_ms"] = time_ms(
                lambda: bg.block_gemm_batched_shared_plain(a, b))
            row["library_ms"] = time_ms(lambda: torch.matmul(a, b))
            row["device_ms"] = time_ms(
                lambda: bg.block_gemm_batched_shared(a, b), hide_host=True)
            row["library_device_ms"] = time_ms(lambda: torch.matmul(a, b),
                                               hide_host=True)
            nbytes = 2 * (G * m * k + k * q) + 4 * G * m * q
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 2.0 * G * m * k * q, "bfloat16")
            if per_step:
                for key, src in (("ms", "kernel_ms"),
                                 ("plain_ms", "plain_ms"),
                                 ("library_ms", "library_ms"),
                                 ("device_ms", "device_ms"),
                                 ("library_device_ms",
                                  "library_device_ms")):
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


def _paged_case(dev, gen, B, K, G, D, page, n_pages, lengths, dtype,
                offset=0):
    """q (B, K, G, D) f32, pools of ``n_pages`` pages in ``dtype`` (shifted
    ``offset`` elements off the 16-byte grid), page tables shuffled over
    the pool, lengths."""
    import torch
    maxp = max(1, -(-max(lengths) // page))
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    pt = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    q = torch.randn((B, K, G, D), generator=gen, device=dev)
    n = n_pages * page * K * D

    def pool():
        buf = torch.randn((n + offset,), generator=gen, device=dev).to(dtype)
        return buf[offset:].view(n_pages, page, K, D)
    kp, vp = pool(), pool()
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln


# B5's 32k lengths, read through page tables
PAGED32K = [32768, 30000, 32768, 20000]
# paged decode cases: (tag, B, K, G, D, page, pool pages, lengths, dtypes,
# pool offset (elements off the 16-byte grid: the element route))
PAGED_CASES = (
    ("ragged", 4, 8, 4, 128, 16, 64, [37, 16, 0, 100], "fb", 0),
    # llama3-8b's heads at the serving path's shape (full), and
    # granite-moe-1b-a400m's at moe_full's
    ("main_path", 4, 8, 4, 128, 16, 64, [23, 23, 23, 23], "fb", 0),
    ("granite", 4, 8, 2, 64, 16, 64, [23, 23, 23, 23], "fb", 0),
    # llama's heads at a 32k context, tables shuffled over 8192 pages
    ("paged32k", 4, 8, 4, 128, 16, 8192, PAGED32K, "fb", 0),
    # the same tokens in pages of 64 and 256 (the same pool bytes)
    ("paged32k_page64", 4, 8, 4, 128, 64, 2048, PAGED32K, "b", 0),
    ("paged32k_page256", 4, 8, 4, 128, 256, 512, PAGED32K, "b", 0),
    # off the fast route's rule: the element route
    ("element_misaligned", 4, 8, 4, 128, 16, 64, [37, 16, 0, 100], "fb", 1),
    ("element_groups24", 2, 2, 24, 64, 16, 64, [300, 5], "fb", 0),
)
# the shapes at which B3 is timed (every dtype the case runs)
PAGED_TIMED = ("main_path", "granite", "paged32k", "paged32k_page64",
               "paged32k_page256")


def _paged_bound(B, K, G, D, lengths, esz, page):
    """Bytes each read once (q f32, the page ids and K and V rows of the
    occupied tokens in the pool's type, the lengths) and written once (the
    output), against 4·G·D operations per occupied token and kv head (f32
    on the CUDA cores)."""
    ntok = sum(lengths)
    pages = sum(-(-n // page) for n in lengths)
    nbytes = 4 * B * K * G * D + 2 * esz * ntok * K * D + 4 * pages \
        + 4 * B + esz * B * K * G * D
    return bound_ms(nbytes, 4.0 * ntok * K * G * D, "float32")


def phase_paged():
    """B3 against its plain version cut alike at every case of
    ``PAGED_CASES`` (f32 within 2e-4 of max(1, largest output), bf16
    within 2^-7 of the largest output), two launches bit for bit, each
    launch counted on the route the pools pick; timed at PAGED_TIMED by
    events and with the host's gaps hidden, beside the bound, the plain version (main_path f32, paged32k bf16) and B5 on the
    same tokens gathered into contiguous caches."""
    import torch
    from repro_torch import ieee_f32
    from repro_torch.kernels import decode_attention as dec
    ieee_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"max_abs_err": 0.0, "timed": {}}
    n0, e0 = dec.launches, dec.paged_element_launches
    n_elem = 0
    for tag, B, K, G, D, page, n_pages, lengths, dts, offset in PAGED_CASES:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            if name[0] not in dts:
                continue
            args = _paged_case(dev, gen, B, K, G, D, page, n_pages, lengths,
                               dt, offset)
            e1 = dec.paged_element_launches
            got = dec.flash_decode_paged(*args)
            again = dec.flash_decode_paged(*args)
            want = dec.flash_decode_paged_plain(*args)
            torch.cuda.synchronize()
            element = dec.paged_element_launches - e1
            n_elem += element
            err = float((got.float() - want.float()).abs().max())
            wmax = float(want.float().abs().max())
            # f32: sums in another order (the reference's 2e-4); bf16: the
            # output is rounded to bf16 (one ulp of the largest output)
            tol, scale = (2e-4, max(1.0, wmax)) if name == "float32" \
                else (BF16_OUT_TOL, wmax)
            zero_ok = all(bool((got[b] == 0).all())
                          for b in range(B) if lengths[b] == 0)
            S = args[3].shape[1] * page
            row = {"phase": "paged", "case": tag, "dtype": name,
                   "B": B, "K": K, "G": G, "D": D, "page": page,
                   "lengths": lengths,
                   "splits": dec.paged_splits(B, K, S, G),
                   "route": "element" if element else "fast",
                   "max_abs_err": err,
                   "bitwise_repeat": bool(torch.equal(got, again))}
            check(err <= tol * scale and zero_ok,
                  f"paged decode {tag} {name}: max abs err {err:.3g}")
            check(row["bitwise_repeat"], f"paged decode {tag} {name}: two "
                  "launches differ")
            check(element == (2 if tag.startswith("element") else 0),
                  f"paged decode {tag} {name}: {element} of 2 launches on "
                  "the element route")
            if name == "float32":
                out["max_abs_err"] = max(out["max_abs_err"], err)
            if tag in PAGED_TIMED:
                def kernel():
                    return dec.flash_decode_paged(*args)
                row["kernel_ms"] = time_ms(kernel, iters=20)
                row["device_ms"] = time_ms(kernel, iters=20, hide_host=True)
                if (tag, name) in (("main_path", "float32"),
                                   ("paged32k", "bfloat16")):
                    row["plain_ms"] = time_ms(
                        lambda: dec.flash_decode_paged_plain(*args),
                        iters=3, reps=3)
                # B5 on the same tokens: the pages gathered into (B, S, K,
                # D) caches beforehand (the copy not timed)
                q, kp, vp, pt, ln = args
                kc = kp[pt.long()].reshape(B, S, K, D)
                vc = vp[pt.long()].reshape(B, S, K, D)
                valid = torch.arange(S, device=dev)[None, :] \
                    < ln.long()[:, None]
                qh = q.reshape(B, 1, K * G, D)
                row["flash_decode_device_ms"] = time_ms(
                    lambda: dec.flash_decode(qh, kc, vc, valid), iters=20,
                    hide_host=True)
                del kc, vc
                row["library_ms"] = None
                row["bound_ms"], row["bound_by"] = _paged_bound(
                    B, K, G, D, lengths, kp.element_size(), page)
                out["timed"][f"{tag}_{name}"] = {
                    k_: row[k_] for k_ in (
                        "kernel_ms", "device_ms", "plain_ms", "flash_decode_device_ms", "bound_ms",
                        "bound_by") if k_ in row}
            emit(row)
            del args, got, again, want
    out["launches_by_route"] = {
        "fast": dec.launches - n0 - (dec.paged_element_launches - e0),
        "element": dec.paged_element_launches - e0}
    check(out["launches_by_route"]["element"] == n_elem,
          f"paged decode: {out['launches_by_route']}")
    return out


# flash attention cases: (tag, B, Sq, Sk, H, K, Dk, Dv, causal, window,
# q_offset)
FLASH_CASES = (
    ("train", 8, 128, 128, 32, 8, 128, 128, True, 0, 0),  # the training step's
    ("prefill", 1, 15, 15, 32, 8, 128, 128, True, 0, 0),  # a serving prefill
    ("window", 2, 256, 256, 32, 8, 128, 128, True, 64, 0),  # a window of 64
    ("gqa", 2, 100, 100, 16, 2, 64, 64, False, 0, 0),  # 8 groups, no mask
    # granite-moe-1b-a400m: 16 heads over 8, D = 64 (moe_full's training
    # step and one serving prefill of 15)
    ("granite_train", 8, 128, 128, 16, 8, 64, 64, True, 0, 0),
    ("granite_prefill", 1, 15, 15, 16, 8, 64, 64, True, 0, 0),
    # no GQA, a head dim off the kernel's 32-column grid, a window
    ("mha_d80", 2, 100, 100, 4, 4, 80, 80, True, 40, 0),
    # deepseek-v2-236b's MLA: q/k of 128 + 64 columns, v of 128, 128 heads
    # each its own kv head (mla_full's training step and one serving
    # prefill of 15), a window off the tile grid, and the reduced config's
    # 48 / 32 (mla_reduced)
    ("mla_train", 8, 128, 128, 128, 128, 192, 128, True, 0, 0),
    ("mla_prefill", 1, 15, 15, 128, 128, 192, 128, True, 0, 0),
    ("mla_window", 2, 100, 100, 8, 8, 192, 128, True, 40, 0),
    ("mla_reduced", 2, 32, 32, 4, 4, 48, 32, True, 0, 0),
    # seamless-m4t-medium: 16 heads, each its own kv head, D = 64
    # (encdec_full's training step): the bidirectional encoder over 256
    # frames, the decoder's causal self-attention, and its
    # cross-attention over twice as many encoder frames, then a serving
    # prefill of 16 over 32 frames
    ("encdec_encoder", 8, 256, 256, 16, 16, 64, 64, False, 0, 0),
    ("encdec_decoder", 8, 128, 128, 16, 16, 64, 64, True, 0, 0),
    ("encdec_cross", 8, 128, 256, 16, 16, 64, 64, False, 0, 0),
    ("encdec_prefill_cross", 1, 16, 32, 16, 16, 64, 64, False, 0, 0),
    # qwen2-vl-72b: 64 heads over 8, D = 128, causal (mrope_full's
    # training step and one serving prefill of 15)
    ("mrope_train", 8, 128, 128, 64, 8, 128, 128, True, 0, 0),
    ("mrope_prefill", 1, 15, 15, 64, 8, 128, 128, True, 0, 0),
    # hymba-1.5b: 25 heads over 5 (G 5), D = 64, causal over its 128 meta
    # tokens put before the sequence, so the queries sit at q_offset 128
    # (hymba_full's training step and a prefill of 4 prompts of 16)
    ("hymba_train", 8, 128, 256, 25, 5, 64, 64, True, 0, 128),
    ("hymba_prefill", 4, 16, 144, 25, 5, 64, 64, True, 0, 128),
    # the same with the meta keys always visible under a sliding window
    # (a 12th field: the prefix): at the training shape with a window of
    # 64, and a 4096-token sequence under hymba's long-context window of
    # 2048 (the key loop visits the prefix's tiles, then jumps)
    ("hymba_prefix_w64", 8, 128, 256, 25, 5, 64, 64, True, 64, 128, 128),
    ("hymba_prefix_w2048", 1, 4096, 4224, 25, 5, 64, 64, True, 2048, 128,
     128),
)
# the cases timed: llama's training shape (f32), MLA's (f32 and bf16),
# seamless's cross-attention and qwen2-vl's training shape (bf16, as
# encdec_full and mrope_full run them), hymba's training shape in f32 (as
# the model's attention upcasts before the kernel) and bf16
FLASH_TIMED = (("train", "float32"), ("mla_train", "float32"),
               ("mla_train", "bfloat16"), ("encdec_cross", "bfloat16"),
               ("mrope_train", "bfloat16"), ("hymba_train", "float32"),
               ("hymba_train", "bfloat16"),
               ("hymba_prefix_w64", "float32"),
               ("hymba_prefix_w64", "bfloat16"),
               ("hymba_prefix_w2048", "float32"),
               ("hymba_prefix_w2048", "bfloat16"))


def _visible_mask(Sq, Sk, causal, window, q_offset=0, prefix=0):
    """(Sq, Sk) bool: which keys each query row attends to; query row i
    sits at position q_offset + i, and the first ``prefix`` keys are
    always visible."""
    import numpy as np
    q = q_offset + np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window:
        ok &= k > q - window
    return ok | (k < prefix)


def _visible_keys(Sq, Sk, causal, window, q_offset=0, prefix=0):
    """Keys each query row attends to, summed over rows (one head)."""
    return int(_visible_mask(Sq, Sk, causal, window, q_offset,
                             prefix).sum())


def phase_flash():
    import torch
    from repro_torch import ieee_f32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    ieee_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"max_abs_err": 0.0, "timed": {}}
    for tag, B, S, Sk, H, K, Dk, Dv, causal, window, q_off, *pre \
            in FLASH_CASES:
        prefix = pre[0] if pre else 0
        G = H // K
        q32 = torch.randn((B * H, S, Dk), generator=gen, device=dev)
        k32 = torch.randn((B * K, Sk, Dk), generator=gen, device=dev)
        v32 = torch.randn((B * K, Sk, Dv), generator=gen, device=dev)
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            opts = dict(causal=causal, window=window, groups=G,
                        q_offset=q_off, prefix=prefix)
            mha = dict(causal=causal, window=window, q_offset=q_off,
                       prefix=prefix)
            got = fa.flash_attention(q, k, v, **opts)
            again = fa.flash_attention(q, k, v, **opts)
            want = fa.flash_attention_plain(q, k, v, **opts)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"flash {tag} {name}: two launches differ")
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            # f32: sums in another order; bf16: one unit in the last place
            # of the largest output (the output and p are rounded to bf16)
            tol = 1e-5 if name == "float32" else 2.0 ** -7
            check(rel <= tol, f"flash {tag} {name}: rel err {rel:.3g}")
            row = {"phase": "flash", "case": tag, "dtype": name, "B": B,
                   "S": S, "Sk": Sk, "H": H, "K": K, "Dk": Dk, "Dv": Dv,
                   "causal": causal, "window": window, "q_offset": q_off,
                   "prefix": prefix,
                   "plan": list(fa.plan(Dk, Dv)), "max_abs_err": err,
                   "rel_err": rel}
            if (tag, name) in FLASH_TIMED:
                # the model's (B, S, H, D) layout, read in place
                q4 = q.reshape(B, H, S, Dk).transpose(1, 2).contiguous()
                k4 = k.reshape(B, K, Sk, Dk).transpose(1, 2).contiguous()
                v4 = v.reshape(B, K, Sk, Dv).transpose(1, 2).contiguous()
                via_ops = ops.mha_flash(q4, k4, v4, **mha)
                check(torch.equal(
                    via_ops.transpose(1, 2).reshape(B * H, S, Dv), got),
                    "flash: mha_flash layout differs")
                row["kernel_ms"] = time_ms(
                    lambda: ops.mha_flash(q4, k4, v4, **mha))
                row["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_plain(q, k, v, **opts),
                    iters=3, reps=3)
                row["device_ms"] = time_ms(
                    lambda: ops.mha_flash(q4, k4, v4, **mha),
                    hide_host=True)
                qh = q.reshape(B, H, S, Dk)
                kh = k.reshape(B, K, Sk, Dk).repeat_interleave(G, dim=1)
                vh = v.reshape(B, K, Sk, Dv).repeat_interleave(G, dim=1)
                # SDPA's is_causal aligns the mask top-left: an offset
                # query block, a window or a prefix takes its mask as a
                # boolean tensor
                lib = dict(is_causal=causal) if not (
                    q_off or window or prefix) else dict(
                    attn_mask=torch.as_tensor(_visible_mask(
                        S, Sk, causal, window, q_off, prefix), device=dev))
                try:
                    row["library_ms"] = time_ms(
                        lambda: sdpa(qh, kh, vh, **lib))
                    row["library_device_ms"] = time_ms(
                        lambda: sdpa(qh, kh, vh, **lib), hide_host=True)
                except RuntimeError as e:
                    row["library_ms"] = row["library_device_ms"] = None
                    row["library_refused"] = str(e)[:200]
                esz = q.element_size()
                nbytes = esz * (B * H * S * (Dk + Dv)
                                + B * K * Sk * (Dk + Dv))
                flops = 2.0 * (Dk + Dv) * B * H * _visible_keys(
                    S, Sk, causal, window, q_off, prefix)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, flops, name)
                out["timed"][f"{tag}_{name}"] = {k_: row.get(k_) for k_ in (
                    "kernel_ms", "plain_ms", "library_ms", "device_ms",
                    "library_device_ms", "library_refused", "bound_ms",
                    "bound_by", "max_abs_err")}
                del q4, k4, v4, qh, kh, vh
            if name == "float32":
                out["max_abs_err"] = max(out["max_abs_err"], err)
            emit(row)
    out.update({k_: v_ for k_, v_ in out["timed"]["train_float32"].items()
                if k_ != "max_abs_err"})
    return out


# flash-decode cases: (tag, B, Smax, H, K, D, per-request occupied slots)
DECODE_CASES = (
    # the full serving cell: 4 slots, cache of 32 (pages of 16), requests
    # at positions 16..23
    ("serving", 4, 32, 32, 8, 128, [17, 18, 19, 24]),
    ("ragged", 4, 200, 32, 8, 128, [1, 200, 73, 130]),
    ("gqa8", 2, 100, 16, 2, 64, [100, 37]),
    ("cache32k", 4, 32768, 32, 8, 128, [32768, 30000, 32768, 20000]),
    # moe_full's serving cell: granite-moe-1b-a400m, 16 heads over 8, D = 64
    ("granite_serving", 4, 32, 16, 8, 64, [17, 18, 19, 24]),
    # encdec_full's decode: the cross-attention of 16 heads over 16, D =
    # 64, over 32 encoder slots, all valid
    ("encdec_cross", 4, 32, 16, 16, 64, [32, 32, 32, 32]),
    # mrope_full's serving decode: qwen2-vl-72b, 64 heads over 8, D =
    # 128, over the session's gathered cache (prompts of 16 and 8 new
    # tokens: 24, rounded up to pages of 16), requests of 16..23 tokens
    ("mrope_serving", 4, 32, 64, 8, 128, [16, 19, 22, 23]),
    # hymba_full's serving decode: 25 heads over 5 (G 5), D = 64, over
    # [128 meta tokens; a cache of 32], the meta slots always valid,
    # requests at positions 16..23
    ("hymba_serving", 4, 128 + 32, 25, 5, 64,
     [128 + 17, 128 + 18, 128 + 19, 128 + 24]),
)


# the shapes at which B5 is timed (every dtype), and B6's: (tag, B, S, H,
# hd, incoming state)
DECODE_TIMED = ("serving", "granite_serving", "cache32k", "encdec_cross",
                "mrope_serving", "hymba_serving")
WKV_TIMED = (("train", 8, 128, 64, 64, False),
             ("decode", 4, 1, 64, 64, True),
             ("prompt100", 4, 100, 64, 64, True))


def _decode_bound(B, H, K, D, lengths, esz):
    """Bytes each read once (q f32, the occupied K and V slots, the mask)
    and written once (the output), against 4·G·D operations per occupied
    slot and kv head (f32 on the CUDA cores)."""
    ntok = sum(lengths)
    nbytes = 4 * B * H * D + 2 * esz * ntok * K * D + B * max(lengths) \
        + esz * B * H * D
    return bound_ms(nbytes, 4.0 * ntok * H * D, "float32")


def _decode_inputs(dev, gen, B, S, H, K, D, lengths):
    """A decode case's f32 query and caches and its per-request mask."""
    import torch
    q = torch.randn((B, 1, H, D), generator=gen, device=dev)
    k32 = torch.randn((B, S, K, D), generator=gen, device=dev)
    v32 = torch.randn((B, S, K, D), generator=gen, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < ln[:, None]
    return q, k32, v32, valid


# a bf16 flash-decode output against its plain version: one bf16 ulp of
# the largest output (both round the same f32 result to bf16)
BF16_OUT_TOL = 2.0 ** -7


def _sdpa_operands(q, k, v, valid):
    """What one ``scaled_dot_product_attention(..., enable_gqa=True)`` call
    reads for the same function: heads-first views of q (in the cache
    type) and of the unrepeated caches, a boolean mask."""
    qh = q.to(k.dtype).transpose(1, 2)
    return qh, k.transpose(1, 2), v.transpose(1, 2), valid[:, None, None, :]


def phase_decode():
    import torch
    from repro_torch import ieee_f32
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models.attention import decode_attention_plain
    ieee_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"max_abs_err": 0.0, "timed": {}}
    n0, e0 = dec.flash_decode_launches, dec.flash_decode_element_launches
    for tag, B, S, H, K, D, lengths in DECODE_CASES:
        q, k32, v32, valid = _decode_inputs(dev, gen, B, S, H, K, D,
                                            lengths)
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            k, v = k32.to(dt), v32.to(dt)
            got = dec.flash_decode(q, k, v, valid)
            want = dec.flash_decode_plain(q, k, v, valid)
            again = dec.flash_decode(q, k, v, valid)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            # f32: sums in another order (the reference's 2e-4); bf16: the
            # output is rounded to bf16 (one ulp of the largest output)
            wmax = float(want.float().abs().max())
            tol, scale = (2e-4, max(1.0, wmax)) if name == "float32" \
                else (BF16_OUT_TOL, wmax)
            row = {"phase": "decode", "case": tag, "dtype": name, "B": B,
                   "Smax": S, "H": H, "K": K, "D": D, "lengths": lengths,
                   "splits": dec.decode_splits(B, K, S),
                   "max_abs_err": err,
                   "bitwise_repeat": bool(torch.equal(got, again))}
            check(err <= tol * scale, f"flash decode {tag} {name}: max abs "
                  f"err {err:.3g}")
            check(row["bitwise_repeat"], f"flash decode {tag} {name}: two "
                  "launches differ")
            if name == "float32":
                # the model's own function (normalised p, rounded q): the
                # same in f32 up to summation order
                ref = decode_attention_plain(q, k, v, valid)
                row["vs_decode_attention"] = float((got - ref).abs().max())
                check(row["vs_decode_attention"] <= tol * scale,
                      f"flash decode {tag}: off decode_attention {row}")
                out["max_abs_err"] = max(out["max_abs_err"], err)
            if tag in DECODE_TIMED:
                def kernel():
                    return dec.flash_decode(q, k, v, valid)
                row["kernel_ms"] = time_ms(kernel, iters=20)
                row["device_ms"] = time_ms(kernel, iters=20, hide_host=True)
                if (tag, name) in (("serving", "float32"),
                                   ("cache32k", "bfloat16")):
                    row["plain_ms"] = time_ms(
                        lambda: dec.flash_decode_plain(q, k, v, valid),
                        iters=3, reps=3)
                qh, kh, vh, mask = _sdpa_operands(q, k, v, valid)

                def library():
                    return sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)
                row["library_ms"] = time_ms(library, iters=20)
                row["library_device_ms"] = time_ms(library, iters=20,
                                                   hide_host=True)
                # the same call on K and V repeated G times beforehand, as
                # SDPA without enable_gqa needs them (the copy not timed)
                kr = kh.repeat_interleave(H // K, dim=1)
                vr = vh.repeat_interleave(H // K, dim=1)
                row["library_repeated_device_ms"] = time_ms(
                    lambda: sdpa(qh, kr, vr, attn_mask=mask), iters=20,
                    hide_host=True)
                del qh, kh, vh, kr, vr
                row["bound_ms"], row["bound_by"] = _decode_bound(
                    B, H, K, D, lengths, k.element_size())
                out["timed"][f"{tag}_{name}"] = {
                    k_: row[k_] for k_ in (
                        "kernel_ms", "device_ms", "plain_ms", "library_ms",
                        "library_device_ms", "library_repeated_device_ms",
                        "bound_ms", "bound_by")
                    if k_ in row}
            emit(row)
            del k, v
    # every case's caches meet the 16-byte rule: all on the cp.async route
    out["launches_by_route"] = {
        "cp_async16": dec.flash_decode_launches - n0
        - (dec.flash_decode_element_launches - e0),
        "element": dec.flash_decode_element_launches - e0}
    check(out["launches_by_route"]["element"] == 0,
          f"flash decode: {out['launches_by_route']}")
    return out


def _wkv_flops(B, S, H, hd, chunk):
    """Operations of the chunked form (what the kernel computes), per chunk
    of c steps: the inter-chunk product and the state carry (2·c·hd² each),
    the pairwise decays and scores (4 per pair j < t and dim: product,
    exp, multiply-add), the diagonal bonus, the intra-chunk product, and
    the elementwise decays."""
    tot = 0.0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        tot += (4 * c * hd * hd + 2 * c * (c - 1) * hd + 3 * c * hd
                + c * (c + 1) * hd + 2 * hd * hd + 6 * c * hd)
    return B * H * tot


def _wkv_inputs(dev, gen, B, S, H, hd, dt, state):
    """r, k, v in ``dt``; the model's decays w = exp(-exp(w0 + lora)) with
    w0 = -2; a small bonus u; a random incoming state or None."""
    import torch
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
               .to(dt) for _ in range(3))
    ww = -2.0 + 0.5 * torch.randn((B, S, H, hd), generator=gen, device=dev)
    w = torch.exp(-torch.exp(ww))
    u = 0.1 * torch.randn((H, hd), generator=gen, device=dev)
    s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev) \
        if state else None
    return r, k, v, w, u, s0


def _wkv_bound(r, w, B, S, H, hd, state):
    """r, k, v (their type), w (f32), u and the incoming state read once,
    y and the last state written once, against the chunked form's
    operations in f32."""
    nbytes = r.numel() * r.element_size() * 3 \
        + 4 * (w.numel() + B * S * H * hd + (1 + state) * B * H * hd * hd
               + H * hd)
    return bound_ms(nbytes, _wkv_flops(B, S, H, hd, 32), "float32")


def phase_wkv():
    import torch
    from repro_torch import ieee_f32
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import wkv6 as wkv
    ieee_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"max_rel_err": 0.0, "timed": {}}
    timed = {t[0] for t in WKV_TIMED}
    e0 = wkv.element_launches

    # (tag, B, S, H, hd, incoming state): the training shape, a prefill
    # of 100 (three chunks of 32 and one of 4), the decode step
    for tag, B, S, H, hd, state in (("train", 8, 128, 64, 64, False),
                                    ("train_state", 8, 128, 64, 64, True),
                                    ("prompt100", 4, 100, 64, 64, True),
                                    ("decode", 4, 1, 64, 64, True)):
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            r, k, v, w, u, s0 = _wkv_inputs(dev, gen, B, S, H, hd, dt, state)
            y, s_last = wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
            yp, sp = wkv.wkv6_plain(r, k, v, w, u, s0, chunk=32)
            y2, s2 = wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
            torch.cuda.synchronize()
            ey = float((y - yp).abs().max() / yp.abs().max())
            es = float((s_last - sp).abs().max() / sp.abs().max())
            row = {"phase": "wkv", "case": tag, "dtype": name, "B": B,
                   "S": S, "H": H, "hd": hd, "state_in": state,
                   "y_rel_err": ey, "s_last_rel_err": es,
                   "y_max_abs_err": float((y - yp).abs().max()),
                   "bitwise_repeat": bool(torch.equal(y, y2)
                                          and torch.equal(s_last, s2))}
            # both sides read the same values and compute the same chunked
            # form in f32, summing in another order
            check(ey <= 1e-5 and es <= 1e-5,
                  f"wkv {tag} {name}: rel err y {ey:.3g}, s_last {es:.3g}")
            check(row["bitwise_repeat"], f"wkv {tag} {name}: two launches "
                  "differ")
            out["max_rel_err"] = max(out["max_rel_err"], ey, es)
            if tag in timed and name == "bfloat16":

                def kernel():
                    return wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
                row["kernel_ms"] = time_ms(kernel)
                row["device_ms"] = time_ms(kernel, hide_host=True)
                if tag == "train":
                    out["max_abs_err"] = row["y_max_abs_err"]
                    row["plain_ms"] = time_ms(
                        lambda: wkv.wkv6_plain(r, k, v, w, u, None,
                                               chunk=32), iters=3, reps=3)
                row["library_ms"] = None     # no single PyTorch call
                row["bound_ms"], row["bound_by"] = _wkv_bound(
                    r, w, B, S, H, hd, state)
                out["timed"][tag] = {k_: row[k_] for k_ in (
                    "kernel_ms", "device_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by") if k_ in row}
            emit(row)
            del r, k, v, w, y, yp, y2
    # the step-exact recurrence, at the reference test's own tolerance
    r, k, v, w, u, _ = _wkv_inputs(dev, gen, 2, 64, 2, 16, torch.float32,
                                   False)
    y, _ = wkv.wkv6(r, k, v, w, u, chunk=16)

    def flat(x):
        return x.transpose(1, 2).reshape(4, 64, 16)
    want = kref.wkv6_ref(flat(r), flat(k), flat(v), flat(w),
                         u[None].expand(2, 2, 16).reshape(4, 16))
    ok = bool(torch.allclose(flat(y), want, rtol=1e-4, atol=1e-3))
    emit({"phase": "wkv", "case": "step_exact", "ok": ok,
          "max_abs_err": float((flat(y) - want).abs().max())})
    check(ok, "wkv: off the step-exact recurrence")
    check(wkv.element_launches == e0, "wkv: a launch took the element route")
    out.update(out["timed"]["train"])
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
    from repro_torch.kernels import flash_attention as fa
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
    dec.launches = dec.paged_element_launches = 0
    dec.flash_decode_launches = dec.flash_decode_element_launches = 0
    fa.launches = 0
    reset_body_counts()
    mark = residual_mark()
    t0 = time.perf_counter()
    with band_gemm_audit(verify=False) as audit:
        first = sess.step()
        first_logits = sess.last_logits.clone()
        rep = sess.run(fail_ids=[3], fail_at_step=1)   # the session's step 2
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    residuals = residual_since(mark, "full")
    # the prefills of the four admissions run the flash kernel, one
    # launch per layer each; every decode step's attention the flash-decode
    # kernel, one launch per layer
    launches = {"band_gemm": bg.launches, "paged_decode": dec.launches,
                "paged_decode_by_route": {
                    "fast": dec.launches - dec.paged_element_launches,
                    "element": dec.paged_element_launches},
                "flash_attention": fa.launches,
                "flash_decode": dec.flash_decode_launches,
                "flash_decode_by_route": {
                    "cp_async16": dec.flash_decode_launches
                    - dec.flash_decode_element_launches,
                    "element": dec.flash_decode_element_launches},
                "freivalds": residuals["freivalds_launches"]}
    bodies = check_bf16_body("full width", audit)

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
        "launches": launches, "band_gemm_bodies": bodies,
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
    check(all(v > 0 for k_, v in launches.items()
              if not k_.endswith("_by_route")),
          f"full width: a kernel was not launched: {launches}")
    check(launches["paged_decode_by_route"] == {"fast": n_steps,
                                                "element": 0},
          f"full width: paged decode launches "
          f"{launches['paged_decode_by_route']} in {n_steps} steps")
    check(launches["flash_decode_by_route"]["element"] == 0,
          f"full width: a flash-decode launch took the element route "
          f"{launches['flash_decode_by_route']}")
    check(launches["flash_decode"] == n_steps * cfg.n_layers,
          f"full width: {launches['flash_decode']} flash-decode launches in "
          f"{n_steps} steps of {cfg.n_layers} layers")

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
    return dict(launches, band_gemm_bodies=bodies)


def _worst_rel(a, b, norm=None) -> float:
    """Largest per-leaf relative difference of two trees: max |a - b| over
    max |a| (the reference's measure), or with ``norm=2`` the L2 norm of
    the difference over the L2 norm of the leaf."""
    from repro_torch import tree as T
    if norm == 2:
        return max(float((x.float() - y.float()).norm()
                         / (x.float().norm() + 1e-12))
                   for x, y in zip(T.leaves(a), T.leaves(b)))
    return max(float((x.float() - y.float()).abs().max()
                     / (x.float().abs().max() + 1e-12))
               for x, y in zip(T.leaves(a), T.leaves(b)))


# the f32-policy parity cells: reduced config and chunk sizes of each
F32_CELLS = {"train_reduced": ("llama3-8b",
                               dict(q_chunk=16, k_chunk=16, loss_chunk=16)),
             "rwkv_reduced": ("rwkv6-7b", dict(loss_chunk=16)),
             "moe_reduced": ("granite-moe-1b-a400m",
                             dict(q_chunk=16, k_chunk=16, loss_chunk=16)),
             "mla_reduced": ("deepseek-v2-236b",
                             dict(q_chunk=16, k_chunk=16, loss_chunk=16)),
             "mrope_reduced": ("qwen2-vl-72b",
                               dict(q_chunk=16, k_chunk=16, loss_chunk=16)),
             "encdec_reduced": ("seamless-m4t-medium",
                                dict(q_chunk=16, k_chunk=16,
                                     loss_chunk=16)),
             "hymba_reduced": ("hymba-1.5b",
                               dict(q_chunk=16, k_chunk=16, loss_chunk=16))}


def f32_cell(cell: str):
    """The set-up of an f32-policy parity cell (:data:`F32_CELLS`): the
    reduced config, the chunk sizes, AdamW's config, params and state from
    seed 0, 2 x 32-token synthetic batches, and two fleet training
    sessions on 8 devices: the f32 policy's and the bf16 control's (every
    fleet GEMM's operands rounded to bf16), which the params checks must
    catch."""
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    arch, chunks = F32_CELLS[cell]
    dev = torch.device("cuda")
    cfg = get_config(arch).reduced()
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=2, total_steps=20)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2, seed=0))
    sessions = []
    for policy in ("f32", "bf16"):
        rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                                device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # PS-local GEMMs
            sessions.append(rt.train_session(opt_cfg, backend="torch",
                                             dtype_policy=policy, **chunks))
    return (cfg, chunks, opt_cfg, params, opt, data) + tuple(sessions)


def phase_train_reduced():
    """Fleet training (f32 policy) against the monolithic step: 3 steps,
    device 2 failing mid-backward at step 1."""
    import torch
    from repro_torch.launch.steps import make_train_step
    dev = torch.device("cuda")
    cfg, chunks, opt_cfg, params, opt, data, sess, ctl = \
        f32_cell("train_reduced")
    mono = make_train_step(cfg, opt_cfg, **chunks)
    p_f, o_f, p_m, o_m, p_c, o_c = params, opt, params, opt, params, opt
    rows, audits = [], []
    for step in range(3):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        fail = dict(fail_ids=[2] if step == 1 else (), fail_at_gemm=20)
        p_m, o_m, met_m = mono(p_m, o_m, batch)
        # 16 forward GEMMs per step: GEMM 20 is in the backward
        with band_gemm_audit(verify=True) as audit:
            mark = residual_mark()
            p_f, o_f, met_f = sess.step(p_f, o_f, batch, **fail)
            res = residual_since(mark, "train_reduced", met_f["fleet"])
        audits.append(audit)
        p_c, o_c, _ = ctl.step(p_c, o_c, batch, **fail)
        rep = met_f["fleet"]
        lm, lf = float(met_m["loss"]), float(met_f["loss"])
        gm, gf = float(met_m["grad_norm"]), float(met_f["grad_norm"])
        rows.append({"step": step, "loss_fleet": lf, "loss_mono": lm,
                     "loss_rel": abs(lf - lm) / abs(lm),
                     "grad_norm_rel": abs(gf - gm) / abs(gm),
                     "n_gemms": rep.n_gemms, "verified": rep.verified,
                     "n_recovered": rep.n_recovered,
                     "failed_ids": list(rep.failed_ids),
                     **res,
                     "band_gemm_checked": audit["checked"],
                     "band_gemm_max_rel_err": audit["max_rel_err"]})
    worst = {"params": _worst_rel(p_m, p_f), "mu": _worst_rel(o_m.mu, o_f.mu),
             "nu": _worst_rel(o_m.nu, o_f.nu),
             "params_l2": _worst_rel(p_m, p_f, norm=2),
             "control_bf16_params": _worst_rel(p_m, p_c),
             "control_bf16_params_l2": _worst_rel(p_m, p_c, norm=2)}
    out = {"bodies": check_bodies("train_reduced", *audits),
           "band_gemm_step": time_band_gemm_set(audits[0]["shapes"])}
    emit({"phase": "train_reduced", "steps": rows, "worst_rel": worst,
          "params_l2_limit": TRAIN_PARAMS_L2_LIMIT, **out})
    # the reference's bar for fleet vs monolithic training: 1e-4 relative
    # (max |difference| over max |leaf|, per leaf) on loss, grad_norm and
    # the moments.  The params are held in L2, per leaf: Adam moves an
    # element whose gradient lies within f32 rounding of zero by about
    # +-lr whichever way its sign falls, so the max-element measure of the
    # params swings across 1e-4 with summation order alone.  The L2 limit
    # lies between the sound runs' readings and the bf16 control's, which
    # must fail it.
    for r in rows:
        check(r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4,
              f"train_reduced step {r['step']}: loss/grad_norm off {r}")
        check(r["verified"], f"train_reduced step {r['step']} unverified")
        check(r["band_gemm_checked"] > 0,
              f"train_reduced step {r['step']}: no band GEMM launch")
    check(max(worst["mu"], worst["nu"]) <= 1e-4,
          f"train_reduced: moments off {worst}")
    check(worst["params_l2"] <= TRAIN_PARAMS_L2_LIMIT,
          f"train_reduced: params off {worst}")
    check(worst["control_bf16_params_l2"] > TRAIN_PARAMS_L2_LIMIT,
          f"train_reduced: the bf16 control passed the params check {worst}")
    check(rows[1]["n_recovered"] > 0 and rows[1]["failed_ids"] == [2],
          "train_reduced: the failure recovered nothing")
    return out


def phase_train_full(cfg):
    """The training path at full width: 3 fleet steps through the band
    GEMM and flash kernels, device 3 failing mid-backward at step 1, then
    a fourth step with every band GEMM launch held against the plain
    version."""
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    dev = torch.device("cuda")
    B, S, n_steps, audited = 8, 128, 4, 3
    chunks = dict(q_chunk=64, k_chunk=64, loss_chunk=64)
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=3, total_steps=n_steps)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step).items()}
               for step in range(n_steps)]

    # the first step's loss and grad_norm on the monolithic path (plain
    # torch.matmul projections), without a second optimizer state
    t0 = time.perf_counter()
    (loss_m, _), grads = M.value_and_grad(cfg, params, batches[0], **chunks)
    gnorm_m = float(adam.global_norm(grads))
    del grads
    torch.cuda.synchronize()
    t_mono = time.perf_counter() - t0

    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    sess = rt.train_session(opt_cfg, backend="torch", dtype_policy="bf16",
                            **chunks)
    bg.launches = 0
    fa.launches = 0
    reset_body_counts()
    rows, reports, audits = [], [], []
    for step, batch in enumerate(batches):
        n_bg, n_fa = bg.launches, fa.launches
        mark = residual_mark()
        torch.cuda.reset_peak_memory_stats()
        # 30 forward GEMMs per step: GEMM 45 is in the backward
        with band_gemm_audit(verify=step == audited) as audit:
            params, opt, met = sess.step(
                params, opt, batch, fail_ids=[3] if step == 1 else (),
                fail_at_gemm=45)
        audits.append(audit)
        rep = met["fleet"]
        reports.append(rep)
        res = residual_since(mark, "train_full", rep)
        kinds = {}
        for r in rep.records:
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
        exec_by_kind = {k: sum(r.exec_time for r in rep.records
                               if r.kind == k) for k in kinds}
        rows.append({
            "step": step, "loss": rep.loss, "grad_norm": rep.grad_norm,
            "wall_s": rep.wall_time, "fleet_exec_s": rep.fleet_exec_time,
            "fleet_exec_s_by_kind": exec_by_kind, "gemms_by_kind": kinds,
            "n_tasks": rep.n_tasks, "n_recovered": rep.n_recovered,
            "failed_ids": list(rep.failed_ids), "verified": rep.verified,
            "all_gemms_verified": all(r.verified for r in rep.records),
            "band_gemm_launches": bg.launches - n_bg,
            "flash_launches": fa.launches - n_fa, **res,
            "band_gemm_checked_against_plain": audit["checked"],
            "band_gemm_max_rel_err": audit["max_rel_err"],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "plan_cache_hit_rate": rep.plan_cache_hit_rate,
            "n_cold_plan_solves": rep.n_cold_plan_solves,
            "predicted_makespan_s": rep.predicted_makespan})
        emit({"phase": "train_full_step", **rows[-1]})
    torch.cuda.synchronize()
    launches = {"band_gemm": bg.launches, "flash_attention": fa.launches,
                "band_gemm_bodies": check_bf16_body("train_full", *audits)}
    first = reports[0]
    loss_rel = abs(first.loss - float(loss_m)) / abs(float(loss_m))
    gnorm_rel = abs(first.grad_norm - gnorm_m) / abs(gnorm_m)
    row = {"phase": "train_full", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": B, "seq": S,
           "param_init_s": t_init, "mono_grad_s": t_mono,
           "loss_mono": float(loss_m), "grad_norm_mono": gnorm_m,
           "first_step_loss_rel": loss_rel,
           "first_step_grad_norm_rel": gnorm_rel, "launches": launches,
           "pad_cache_hit_rate": rt._pad_cache.hit_rate}
    emit(row)
    fwd = first.n_gemms // 3
    for r in rows:
        check(r["verified"] and r["all_gemms_verified"],
              f"train_full step {r['step']}: a GEMM failed verification")
        check(r["gemms_by_kind"] == {"fwd": fwd, "dA": fwd, "dW": fwd},
              f"train_full step {r['step']}: GEMM kinds {r['gemms_by_kind']}")
        check(r["band_gemm_launches"] > 0 and r["flash_launches"] > 0,
              f"train_full step {r['step']}: a kernel was not launched")
        check(bool(torch.isfinite(torch.tensor(r["loss"]))),
              f"train_full step {r['step']}: loss {r['loss']}")
    check(rows[audited]["band_gemm_checked_against_plain"]
          == rows[audited]["band_gemm_launches"],
          f"train_full: step {audited} checked "
          f"{rows[audited]['band_gemm_checked_against_plain']} of "
          f"{rows[audited]['band_gemm_launches']} band GEMM launches")
    check(rows[1]["failed_ids"] == [3] and rows[1]["n_recovered"] > 0,
          "train_full: the failure did not fire or recovered nothing")
    # every GEMM output is rounded to bf16, in another order on each path
    check(loss_rel <= 1e-2, f"train_full: first-step loss rel {loss_rel}")
    check(gnorm_rel <= 5e-2, f"train_full: first-step grad_norm rel "
          f"{gnorm_rel}")

    # the first step's band GEMM launches, timed apart from the run (these
    # launches come after the counts were read)
    del params, opt, met, batches
    torch.cuda.empty_cache()
    gemm_set = time_band_gemm_set(audits[0]["shapes"])
    gemm_set["max_abs_err"] = audits[audited]["max_abs_err"]
    gemm_set["max_rel_err"] = audits[audited]["max_rel_err"]
    emit({"phase": "train_full_band_gemm_set", "step": 0, **gemm_set})
    check(gemm_set["launches"] == rows[0]["band_gemm_launches"],
          "train_full: the timed set is not step 0's launches")
    return launches, gemm_set


def _rwkv_greedy(cfg, params, prompts, n_new, dev):
    """Greedy continuation two ways: one prefill of the prompts, then
    ``n_new`` decode steps on its states; and the prompts fed token by
    token through ``decode_step`` from ``init_cache``.  Both paths take the
    token the prefill's logits pick first, then each its own argmax.
    Returns, per path, the tokens and the first decode step's logits."""
    import torch
    from repro_torch.models import model as M
    toks = torch.as_tensor(prompts, device=dev)
    B, P = toks.shape
    lg, cache = M.prefill(cfg, params, {"tokens": toks})
    cache_tbt = M.init_cache(cfg, B, P, device=dev)
    for t in range(P):
        _, cache_tbt = M.decode_step(cfg, params, cache_tbt, toks[:, t:t + 1])
    nxt0 = torch.argmax(lg[:, -1, :cfg.vocab_size], dim=-1)[:, None]
    out = []
    for cache_ in (cache, cache_tbt):
        nxt, seq, first = nxt0, [], None
        for _ in range(n_new):
            seq.append(nxt)
            lg_, cache_ = M.decode_step(cfg, params, cache_, nxt)
            first = lg_ if first is None else first
            nxt = torch.argmax(lg_[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        out.append((torch.cat(seq, dim=1).cpu().tolist(), first))
    return out


def phase_rwkv_reduced():
    """RWKV fleet training (f32 policy) against the monolithic step: 3
    steps, device 2 failing at GEMM 3 (in the backward) of step 1; then
    greedy serving against token-by-token decoding."""
    import numpy as np
    import torch
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.launch.steps import make_train_step
    dev = torch.device("cuda")
    cfg, chunks, opt_cfg, params, opt, data, sess, ctl = \
        f32_cell("rwkv_reduced")
    mono = make_train_step(cfg, opt_cfg, **chunks)
    p_f, o_f, p_m, o_m, p_c, o_c = params, opt, params, opt, params, opt
    rows, audits = [], []
    wkv.launches = 0
    for step in range(3):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        # 2 loss chunks: GEMMs 0-1 forward, 2-5 the backward
        fail = dict(fail_ids=[2] if step == 1 else (), fail_at_gemm=3)
        p_m, o_m, met_m = mono(p_m, o_m, batch)
        with band_gemm_audit(verify=True) as audit:
            mark = residual_mark()
            p_f, o_f, met_f = sess.step(p_f, o_f, batch, **fail)
            res = residual_since(mark, "rwkv_reduced", met_f["fleet"])
        audits.append(audit)
        p_c, o_c, _ = ctl.step(p_c, o_c, batch, **fail)
        rep = met_f["fleet"]
        lm, lf = float(met_m["loss"]), float(met_f["loss"])
        gm, gf = float(met_m["grad_norm"]), float(met_f["grad_norm"])
        rows.append({"step": step, "loss_fleet": lf, "loss_mono": lm,
                     "loss_rel": abs(lf - lm) / abs(lm),
                     "grad_norm_rel": abs(gf - gm) / abs(gm),
                     "n_gemms": rep.n_gemms, "verified": rep.verified,
                     "n_recovered": rep.n_recovered,
                     "failed_ids": list(rep.failed_ids),
                     **res,
                     "band_gemm_checked": audit["checked"],
                     "band_gemm_max_rel_err": audit["max_rel_err"]})
    train_wkv = wkv.launches
    worst = {"params": _worst_rel(p_m, p_f), "mu": _worst_rel(o_m.mu, o_f.mu),
             "nu": _worst_rel(o_m.nu, o_f.nu),
             "params_l2": _worst_rel(p_m, p_f, norm=2),
             "control_bf16_params_l2": _worst_rel(p_m, p_c, norm=2)}
    rng = np.random.default_rng(2)
    # a prompt of 40: one chunk of 32 and a ragged one of 8 in the kernel
    prompts = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int64)
    wkv.launches = 0
    (toks, _), (toks_tbt, _) = _rwkv_greedy(cfg, p_f, prompts, 8, dev)
    serve_wkv = wkv.launches
    out = {"bodies": check_bodies("rwkv_reduced", *audits),
           "band_gemm_step": time_band_gemm_set(audits[0]["shapes"])}
    emit({"phase": "rwkv_reduced", "steps": rows, "worst_rel": worst,
          "params_l2_limit": TRAIN_PARAMS_L2_LIMIT, **out,
          "wkv_launches_training": train_wkv,
          "wkv_launches_serving": serve_wkv,
          "greedy_tokens": toks, "greedy_tokens_match": toks == toks_tbt})
    for r in rows:
        check(r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4,
              f"rwkv_reduced step {r['step']}: loss/grad_norm off {r}")
        check(r["verified"] and r["band_gemm_checked"] > 0,
              f"rwkv_reduced step {r['step']}: unverified or no launch {r}")
    check(max(worst["mu"], worst["nu"]) <= 1e-4,
          f"rwkv_reduced: moments off {worst}")
    # params in L2, as train_reduced holds them (the max-element measure
    # reads summation order where Adam meets a gradient near zero)
    check(worst["params_l2"] <= TRAIN_PARAMS_L2_LIMIT,
          f"rwkv_reduced: params off {worst}")
    check(worst["control_bf16_params_l2"] > TRAIN_PARAMS_L2_LIMIT,
          f"rwkv_reduced: the bf16 control passed the params check {worst}")
    check(rows[1]["n_recovered"] > 0 and rows[1]["failed_ids"] == [2],
          "rwkv_reduced: the failure recovered nothing")
    # 2 layers: one WKV launch per layer and step in the fleet runs (the
    # control too), two in the monolithic step (its backward recomputes
    # each layer: remat), one per prefill and per decode step
    check(train_wkv == 3 * (2 + 1 + 1) * cfg.n_layers,
          f"rwkv_reduced: {train_wkv} WKV launches in training")
    check(serve_wkv == (1 + 40 + 2 * 8) * cfg.n_layers,
          f"rwkv_reduced: {serve_wkv} WKV launches in serving")
    check(toks == toks_tbt, f"rwkv_reduced: greedy tokens {toks} != "
          f"token-by-token {toks_tbt}")
    return out


def phase_rwkv_full(cfg):
    """RWKV at full width: 3 fleet training steps, device 3 failing at GEMM
    3 (in the backward) of step 1, the first step against the monolithic
    path; then serving, prefill against token-by-token decoding."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    dev = torch.device("cuda")
    B, S, n_steps = 8, 128, 3
    chunks = dict(loss_chunk=64)
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=3, total_steps=n_steps)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in T.leaves(params))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step).items()}
               for step in range(n_steps)]
    t0 = time.perf_counter()
    (loss_m, _), grads = M.value_and_grad(cfg, params, batches[0], **chunks)
    gnorm_m = float(adam.global_norm(grads))
    del grads
    torch.cuda.synchronize()
    t_mono = time.perf_counter() - t0

    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # PS-local GEMMs
        sess = rt.train_session(opt_cfg, backend="torch",
                                dtype_policy="bf16", **chunks)
    rows = []
    wkv.launches = wkv.element_launches = 0
    bg.launches = 0
    reset_body_counts()
    torch.cuda.reset_peak_memory_stats()
    with band_gemm_audit(verify=False) as b1_audit:
        for step, batch in enumerate(batches):
            n_w, n_b = wkv.launches, bg.launches
            mark = residual_mark()
            params, opt, met = sess.step(
                params, opt, batch, fail_ids=[3] if step == 1 else (),
                fail_at_gemm=3)
            rep = met["fleet"]
            res = residual_since(mark, "rwkv_full", rep)
            rows.append({
                "step": step, "loss": rep.loss, "grad_norm": rep.grad_norm,
                "wall_s": rep.wall_time, "fleet_exec_s": rep.fleet_exec_time,
                "n_gemms": rep.n_gemms, "n_tasks": rep.n_tasks,
                "n_recovered": rep.n_recovered,
                "failed_ids": list(rep.failed_ids), "verified": rep.verified,
                "wkv_launches": wkv.launches - n_w,
                "band_gemm_launches": bg.launches - n_b, **res})
            emit({"phase": "rwkv_full_step", **rows[-1]})
    torch.cuda.synchronize()
    train_launches = {"wkv6": wkv.launches, "band_gemm": bg.launches,
                      "band_gemm_bodies": check_bf16_body("rwkv_full",
                                                          b1_audit)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del opt, met, batches

    # serving: 4 prompts of 16, prefill then 8 decode steps
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    wkv.launches = 0
    t0 = time.perf_counter()
    (toks, first), (toks_tbt, first_tbt) = _rwkv_greedy(cfg, params,
                                                         prompts, 8, dev)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    serve_wkv = wkv.launches
    V = cfg.vocab_size
    diff = (first[..., :V] - first_tbt[..., :V]).float()
    rel_l2 = float(diff.norm() / first_tbt[..., :V].float().norm())
    loss_rel = abs(rows[0]["loss"] - float(loss_m)) / abs(float(loss_m))
    gnorm_rel = abs(rows[0]["grad_norm"] - gnorm_m) / abs(gnorm_m)
    row = {"phase": "rwkv_full", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": cfg.d_model // cfg.rwkv_head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "n_params": n_params,
           "batch": B, "seq": S, "param_init_s": t_init,
           "mono_grad_s": t_mono, "loss_mono": float(loss_m),
           "grad_norm_mono": gnorm_m, "first_step_loss_rel": loss_rel,
           "first_step_grad_norm_rel": gnorm_rel,
           "launches_training": train_launches,
           "max_memory_allocated_gb": peak_gb, "serve_s": t_serve,
           "wkv_launches_serving": serve_wkv,
           "first_decode_logits_rel_l2": rel_l2,
           "greedy_tokens_match": toks == toks_tbt}
    emit(row)
    for r in rows:
        check(r["verified"], f"rwkv_full step {r['step']}: unverified")
        check(r["wkv_launches"] == cfg.n_layers and r["band_gemm_launches"] > 0,
              f"rwkv_full step {r['step']}: kernel launches {r}")
        check(bool(np.isfinite(r["loss"])), f"rwkv_full step {r['step']}: "
              f"loss {r['loss']}")
    check(rows[1]["failed_ids"] == [3] and rows[1]["n_recovered"] > 0,
          "rwkv_full: the failure did not fire or recovered nothing")
    # every GEMM output is rounded to bf16, in another order on each path
    check(loss_rel <= 1e-2, f"rwkv_full: first-step loss rel {loss_rel}")
    check(gnorm_rel <= 5e-2, f"rwkv_full: first-step grad_norm rel "
          f"{gnorm_rel}")
    # prefill (1 launch per layer), 16 token-by-token steps, and 8 decode
    # steps on each path, one launch per layer each
    check(serve_wkv == (1 + 16 + 2 * 8) * cfg.n_layers,
          f"rwkv_full: {serve_wkv} WKV launches in serving")
    check(wkv.element_launches == 0,
          f"rwkv_full: {wkv.element_launches} WKV launches took the element "
          "route")
    # the chunked and the one-step forms round differently in bf16
    check(rel_l2 <= 2e-2, f"rwkv_full: first decode step's logits rel L2 "
          f"{rel_l2}")
    return {"training": train_launches["wkv6"], "serving": serve_wkv}


# ----------------------------------------------------------------- the MoE --

def moe_expert_shapes(cfg, n_tokens: int, backward: bool):
    """The batched block GEMM launches of one MoE layer routing
    ``n_tokens`` tokens, as ``(A shape, B shape)``: the forward's gate, up
    and down products, and with ``backward`` each one's dA (dC · Wᵀ) and
    dW (Aᵀ · dC)."""
    from repro_torch.models import moe as MOE
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    C = MOE.capacity(cfg, n_tokens)
    up, down = ((E, C, d), (E, d, ff)), ((E, C, ff), (E, ff, d))
    shapes = [up, up, down]
    if backward:
        shapes += [down, ((E, d, C), (E, C, ff))] * 2      # gate, up
        shapes += [up, ((E, ff, C), (E, C, d))]            # down
    return shapes


def _set_sum(counts, rows, n_layers, err_key="bfloat16_max_abs_err"):
    """Per-launch times of ``rows`` summed over a step's launch set."""
    tot = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "device_ms": 0.0, "library_device_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "max_abs_err": 0.0}
    for shape, n in counts.items():
        row, n = rows[shape], n * n_layers
        tot["launches"] += n
        for key in ("ms", "plain_ms", "library_ms", "device_ms",
                    "library_device_ms", "bytes_ms", "ops_ms"):
            tot[key] += n * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], row[err_key])
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    return tot


def phase_bgemm(cfg):
    """The batched block GEMM at every shape of a full-width MoE training
    step (batch 8 x 128) and decode step (4 slots), and the plain block
    GEMM at the kernels benchmark's shape."""
    import torch
    from repro_torch import ieee_f32
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import ops
    ieee_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    train = collections.Counter(moe_expert_shapes(cfg, 8 * 128, True))
    decode = collections.Counter(moe_expert_shapes(cfg, 4, False))
    rows = {}
    for ash, bsh in sorted(set(train) | set(decode)):
        a32 = torch.randn(ash, generator=gen, device=dev)
        b32 = torch.randn(bsh, generator=gen, device=dev) / ash[2] ** 0.5
        row = {"A": list(ash), "B": list(bsh)}
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            a, b = a32.to(dt), b32.to(dt)
            n_tc, n_fma, n_cp = (bg.tc_launches, bg.fma_launches,
                                 bg.aligned_copies)
            got = bg.block_gemm_batched(a, b)
            want = bg.block_gemm_batched_plain(a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            # both types: the same values' exact products summed in f32 on
            # both sides, in another order, and an f32 output, so the band
            # GEMM's bar holds for bf16 operands too
            check(rel <= 1e-5, f"bgemm {name} {ash}x{bsh}: rel err {rel:.3g}")
            bf16 = dt == torch.bfloat16
            check(bg.tc_launches - n_tc == bf16
                  and bg.fma_launches - n_fma == (not bf16)
                  and bg.aligned_copies == n_cp,
                  f"bgemm {name} {ash}x{bsh}: {bg.tc_launches - n_tc} "
                  f"wgmma and {bg.fma_launches - n_fma} FMA launches, "
                  f"{bg.aligned_copies - n_cp} aligned copies")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_rel_err"] = rel
        # timed in bf16, the full-width path's type
        a, b = a32.bfloat16(), b32.bfloat16()
        row["ms"] = time_ms(lambda: bg.block_gemm_batched(a, b))
        row["plain_ms"] = time_ms(lambda: bg.block_gemm_batched_plain(a, b))
        row["library_ms"] = time_ms(lambda: torch.bmm(a, b))
        row["device_ms"] = time_ms(lambda: bg.block_gemm_batched(a, b),
                                   hide_host=True)
        row["library_device_ms"] = time_ms(lambda: torch.bmm(a, b),
                                           hide_host=True)
        G, m, k = ash
        n = bsh[2]
        nbytes = 2 * (G * m * k + G * k * n) + 4 * G * m * n
        row["bytes_ms"] = nbytes / PEAK_BW * 1e3
        row["ops_ms"] = 2.0 * G * m * k * n / PEAK_OPS["bfloat16"] * 1e3
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2.0 * G * m * k * n, "bfloat16")
        row["per_train_step"] = train[(ash, bsh)] * cfg.n_layers
        row["per_decode_step"] = decode[(ash, bsh)] * cfg.n_layers
        rows[(ash, bsh)] = row
        emit({"phase": "bgemm", **row})
        del a32, b32, a, b
    # G > 1 off the tile grid (m 100 and 37, k 336 and 333); the second
    # also off TMA's 8-element alignment (k 333, n 77: both bf16 operands
    # are copied), checked, not timed
    for ash, bsh in (((6, 100, 336), (6, 336, 200)),
                     ((5, 37, 333), (5, 333, 77))):
        a32 = torch.randn(ash, generator=gen, device=dev)
        b32 = torch.randn(bsh, generator=gen, device=dev) / ash[2] ** 0.5
        row = {"case": "ragged", "A": list(ash), "B": list(bsh)}
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            a, b = a32.to(dt), b32.to(dt)
            n_tc, n_fma, n_cp = (bg.tc_launches, bg.fma_launches,
                                 bg.aligned_copies)
            got = bg.block_gemm_batched(a, b)
            want = bg.block_gemm_batched_plain(a, b)
            torch.cuda.synchronize()
            rel = float((got - want).abs().max() / want.abs().max())
            bf16 = dt == torch.bfloat16
            copies = sum(not bg.tma_ready(x) for x in (a, b)) if bf16 else 0
            check(rel <= 1e-5 and bg.tc_launches - n_tc == bf16
                  and bg.fma_launches - n_fma == (not bf16)
                  and bg.aligned_copies - n_cp == copies,
                  f"bgemm {name} {ash}x{bsh}: rel err {rel:.3g}, "
                  f"{bg.tc_launches - n_tc} wgmma and "
                  f"{bg.fma_launches - n_fma} FMA launches, "
                  f"{bg.aligned_copies - n_cp} aligned copies")
            row[f"{name}_rel_err"] = rel
            row[f"{name}_aligned_copies"] = copies
        emit({"phase": "bgemm", **row})
        del a32, b32, a, b

    # the decode step's products as it runs them: f32 capacity buffers
    # against the bf16 expert weights as stored (the FMA body widens them),
    # which must give the bits of the call on f32 copies of the weights;
    # beside one torch.bmm in f32 and the bytes the launch reads
    f32_rows = {}
    for ash, bsh in sorted(decode):
        a = torch.randn(ash, generator=gen, device=dev)
        w = (torch.randn(bsh, generator=gen, device=dev)
             / ash[2] ** 0.5).bfloat16()
        wf = w.float()
        n_fma = bg.fma_launches
        got = bg.block_gemm_batched(a, w)
        check(bg.fma_launches - n_fma == 1,
              f"bgemm f32 x bf16 {ash}x{bsh}: {bg.fma_launches - n_fma} "
              "FMA launches")
        promoted = bg.block_gemm_batched(a, wf)
        want = bg.block_gemm_batched_plain(a, w)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        tiling, plan = bg.fma_plan(ash[0], ash[1], bsh[2], ash[2])
        row = {"case": "decode_f32_bf16", "A": list(ash), "B": list(bsh),
               "tiling": tiling, "split_k_slices": len(plan) - 1,
               "max_abs_err": err, "rel_err": rel,
               "bitwise_equal_promoted": bool(torch.equal(got, promoted))}
        check(rel <= 1e-5 and row["bitwise_equal_promoted"],
              f"bgemm f32 x bf16 {row}")
        row["ms"] = time_ms(lambda: bg.block_gemm_batched(a, w))
        row["plain_ms"] = time_ms(lambda: bg.block_gemm_batched_plain(a, w))
        row["library_ms"] = time_ms(lambda: torch.bmm(a, wf))
        row["device_ms"] = time_ms(lambda: bg.block_gemm_batched(a, w),
                                   hide_host=True)
        row["library_device_ms"] = time_ms(lambda: torch.bmm(a, wf),
                                           hide_host=True)
        G, m, k = ash
        n = bsh[2]
        row["bytes_ms"] = (4 * G * m * k + 2 * G * k * n
                           + 4 * G * m * n) / PEAK_BW * 1e3
        row["ops_ms"] = 2.0 * G * m * k * n / PEAK_OPS["float32"] * 1e3
        f32_rows[(ash, bsh)] = row
        emit({"phase": "bgemm", **row})
        del a, w, wf, got, promoted, want

    out = {"train_step": _set_sum(train, rows, cfg.n_layers),
           "decode_step": _set_sum(decode, rows, cfg.n_layers),
           "decode_step_f32": _set_sum(decode, f32_rows, cfg.n_layers,
                                       err_key="max_abs_err"),
           "train_shapes": train}
    emit({"phase": "bgemm_steps", "train_step": out["train_step"],
          "decode_step": out["decode_step"],
          "decode_step_f32": out["decode_step_f32"]})

    # block_gemm at benchmarks/kernels_bench.py's shape (512^3, f32), the
    # way that benchmark calls it (``ops.block_gemm``), once as the path
    a = torch.randn((512, 512), generator=gen, device=dev)
    b = torch.randn((512, 512), generator=gen, device=dev)
    bg.block_gemm_launches = 0
    reset_body_counts()
    got = ops.block_gemm(a, b)
    torch.cuda.synchronize()
    launches = bg.block_gemm_launches
    bodies = {"wgmma_bf16": bg.tc_launches, "fma_f32": bg.fma_launches}
    want = bg.block_gemm_plain(a, b)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    check(launches == 1 and bodies == {"wgmma_bf16": 0, "fma_f32": 1}
          and rel <= 1e-5, f"block_gemm 512^3 f32: {launches} launches, "
          f"bodies {bodies}, rel err {rel:.3g}")
    # and once in bf16, the wgmma/TMA body, with no aligned copy
    ab, bb = a.bfloat16(), b.bfloat16()
    reset_body_counts()
    got16 = bg.block_gemm(ab, bb)
    bodies16 = {"wgmma_bf16": bg.tc_launches, "fma_f32": bg.fma_launches}
    want16 = bg.block_gemm_plain(ab, bb)
    rel16 = float((got16 - want16).abs().max() / want16.abs().max())
    check(bodies16 == {"wgmma_bf16": 1, "fma_f32": 0}
          and bg.aligned_copies == 0 and rel16 <= 1e-5,
          f"block_gemm 512^3 bf16: bodies {bodies16}, "
          f"{bg.aligned_copies} aligned copies, rel err {rel16:.3g}")
    row = {"m": 512, "k": 512, "n": 512, "dtype": "float32",
           "launches": launches, "max_abs_err": err, "rel_err": rel,
           "bfloat16_rel_err": rel16,
           "launches_by_body": {b: bodies[b] + bodies16[b] for b in bodies},
           "tiling": bg.fma_plan(1, 512, 512, 512)[0],
           "split_k_slices": len(bg.fma_plan(1, 512, 512, 512)[1]) - 1,
           "ms": time_ms(lambda: ops.block_gemm(a, b), iters=20),
           "plain_ms": time_ms(lambda: bg.block_gemm_plain(a, b), iters=20),
           "library_ms": time_ms(lambda: torch.matmul(a, b), iters=20),
           "device_ms": time_ms(lambda: ops.block_gemm(a, b), iters=20,
                                hide_host=True),
           "library_device_ms": time_ms(lambda: torch.matmul(a, b),
                                        iters=20, hide_host=True)}
    row["bound_ms"], row["bound_by"] = bound_ms(4 * 3 * 512 * 512,
                                                2.0 * 512 ** 3, "float32")
    emit({"phase": "bgemm", "case": "block_gemm", **row})
    out["block_gemm"] = row
    return out


# (G, m, k, n, per-g B): llama3-8b decode q/o, k/v, gate/up, down and a
# 3-band q; the LM head's training dA; granite's expert decode products;
# llama's training forward (a full grid)
SPLIT_SHAPES = ((1, 128, 4096, 4096, False), (1, 128, 4096, 1024, False),
                (1, 128, 4096, 14336, False), (1, 128, 14336, 4096, False),
                (3, 128, 4096, 4096, False), (1, 512, 128256, 4096, False),
                (32, 4, 1024, 512, True), (32, 4, 512, 1024, True),
                (1, 1024, 4096, 14336, False))
SPLIT_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16)
# (G, m, k, n, per-g B, B's type) of the f32 body: the kernels benchmark's
# 512^3; granite's expert decode products as the decode step runs them;
# f32-policy cells' buckets (train_reduced, moe_reduced's experts);
# llama's decode buckets in f32 (32, 64, 96 and 112 tiles of 128 x 128)
# and the full-width f32 buckets the gemm phase checks (llama's training
# forward, the LM head's training dA: 896 and 128 tiles)
F32_SPLIT_SHAPES = ((1, 512, 512, 512, False, "float32"),
                    (32, 4, 1024, 512, True, "bfloat16"),
                    (32, 4, 512, 1024, True, "bfloat16"),
                    (2, 128, 256, 128, False, "float32"),
                    (1, 128, 1024, 256, False, "float32"),
                    (1, 256, 128, 1024, False, "float32"),
                    (4, 40, 256, 64, True, "float32"),
                    (4, 256, 40, 64, True, "float32"),
                    (1, 128, 4096, 4096, False, "float32"),
                    (2, 128, 4096, 4096, False, "float32"),
                    (3, 128, 4096, 4096, False, "float32"),
                    (1, 128, 4096, 14336, False, "float32"),
                    (1, 1024, 4096, 14336, False, "float32"),
                    (1, 512, 128256, 4096, False, "float32"))
F32_SPLIT_COUNTS = (1, 2, 3, 4, 6, 8)


# B5's split sweep: the 32k cell, a 4k-token cache, llama's and granite's
# serving shapes (tag, B, Smax, H, K, D, lengths), bf16
DECODE_SPLIT_CASES = (
    ("cache32k", 4, 32768, 32, 8, 128, [32768, 30000, 32768, 20000]),
    ("cache4k", 4, 4096, 32, 8, 128, [4096, 3000, 4096, 2000]),
    ("serving", 4, 32, 32, 8, 128, [17, 18, 19, 24]),
    ("granite_serving", 4, 32, 16, 8, 64, [17, 18, 19, 24]))
DECODE_SPLITS = (256, 512, 1024, 2048, 4096)


def split_decode():
    """B5 at each split size (256 to 4096 slots, those under Smax, and the
    rule's own), each held against the plain version cut alike, device
    times with the host's gaps hidden."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    for tag, B, S, H, K, D, lengths in DECODE_SPLIT_CASES:
        q, k32, v32, valid = _decode_inputs(dev, gen, B, S, H, K, D,
                                            lengths)
        k, v = k32.bfloat16(), v32.bfloat16()
        del k32, v32
        rule = dec.decode_splits(B, K, S)[0]
        row = {"phase": "split", "kernel": "flash_decode", "case": tag,
               "B": B, "Smax": S, "H": H, "K": K, "D": D,
               "rule_split": rule, "ms_by_split": {}}
        for split in sorted({x for x in DECODE_SPLITS if x < S} | {rule}):
            want = dec.flash_decode_plain(q, k, v, valid, split=split)
            got = dec.flash_decode(q, k, v, valid, _split=split)
            err = float((got.float() - want.float()).abs().max())
            check(err <= BF16_OUT_TOL * float(want.float().abs().max()),
                  f"split flash_decode {tag} {split}: err {err:.3g}")
            row["ms_by_split"][split] = time_ms(
                lambda: dec.flash_decode(q, k, v, valid, _split=split),
                iters=20, hide_host=True)
        emit(row)
        del q, k, v


PAGED_SPLITS = (1024, 1536, 2048, 2560, 3072, 4096)


def split_paged():
    """B3 at the paged 32k cell (bf16, pages of 16) at each split size
    (1024 to 4096 tokens, and the rule's own), each held against the plain
    version cut alike, device times with the host's gaps hidden."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    tag, B, K, G, D, page, n_pages, lengths, _, _ = next(
        c for c in PAGED_CASES if c[0] == "paged32k")
    args = _paged_case(dev, gen, B, K, G, D, page, n_pages, lengths,
                       torch.bfloat16)
    rule = dec.paged_splits(B, K, args[3].shape[1] * page, G)[0]
    row = {"phase": "split", "kernel": "paged_decode", "case": tag,
           "rule_split": rule, "ms_by_split": {}}
    for split in sorted(set(PAGED_SPLITS) | {rule}):
        want = dec.flash_decode_paged_plain(*args, split=split)
        got = dec.flash_decode_paged(*args, _split=split)
        err = float((got.float() - want.float()).abs().max())
        check(err <= BF16_OUT_TOL * float(want.float().abs().max()),
              f"split paged_decode {split}: err {err:.3g}")
        row["ms_by_split"][split] = time_ms(
            lambda: dec.flash_decode_paged(*args, _split=split), iters=20,
            hide_host=True)
    emit(row)


def phase_split():
    """B5's and B3's split sizes (:func:`split_decode`,
    :func:`split_paged`).  Then the device time of
    the bf16 body at each split count of the contraction (at most one slice per KSPAN span), beside the rule's own
    count and one ``torch.matmul``; every split held against the unsplit
    result (1e-5 relative).  Then the f32 body at each of its tilings and
    split counts beside the rule's pick (against the rule's result), and
    flash attention at each of its block shapes (against the plain
    version)."""
    import torch
    from repro_torch.kernels import block_gemm as bg
    split_decode()
    split_paged()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for G, m, k, n, per_g in SPLIT_SHAPES:
        a = torch.randn((G, m, k), generator=gen, device=dev).bfloat16()
        b = (torch.randn((G, k, n) if per_g else (k, n), generator=gen,
                         device=dev) / k ** 0.5).bfloat16()
        entry, fn = (("block_gemm_batched", bg.block_gemm_batched) if per_g
                     else ("band_gemm", bg.block_gemm_batched_shared))
        c = torch.empty((G, m, n), dtype=torch.float32, device=dev)
        row = {"G": G, "m": m, "k": k, "n": n, "per_g_b": per_g,
               "tiles": G * -(-m // bg.TILE) * -(-n // bg.TILE),
               "rule_slices": len(bg.split_plan(G, m, n, k)) - 1,
               "ms_by_slices": {}}
        want = torch.empty_like(c)
        bg._launch(entry, a, b, want, slices=1)
        for S in (x for x in SPLIT_COUNTS if x <= -(-k // bg.KSPAN)):
            bg._launch(entry, a, b, c, slices=S)
            rel = float((c - want).abs().max() / want.abs().max())
            check(rel <= 1e-5, f"split {row}: {S} slices, rel err {rel:.3g}")
            row["ms_by_slices"][S] = time_ms(
                lambda: bg._launch(entry, a, b, c, slices=S), hide_host=True)
        row["rule_ms"] = time_ms(lambda: fn(a, b), hide_host=True)
        row["library_ms"] = time_ms(lambda: torch.matmul(a, b),
                                    hide_host=True)
        emit({"phase": "split", **row})
        del a, b, c, want

    # the f32 body: every tiling that covers the rows, at each split
    for G, m, k, n, per_g, b_type in F32_SPLIT_SHAPES:
        a = torch.randn((G, m, k), generator=gen, device=dev)
        b = (torch.randn((G, k, n) if per_g else (k, n), generator=gen,
                         device=dev) / k ** 0.5).to(getattr(torch, b_type))
        entry, fn = (("block_gemm_batched", bg.block_gemm_batched) if per_g
                     else ("band_gemm", bg.block_gemm_batched_shared))
        c = torch.empty((G, m, n), dtype=torch.float32, device=dev)
        tiling, plan = bg.fma_plan(G, m, n, k)
        row = {"G": G, "m": m, "k": k, "n": n, "per_g_b": per_g,
               "b_type": b_type, "rule_tiling": tiling,
               "rule_slices": len(plan) - 1, "ms_by_tiling_slices": {}}
        want = fn(a, b)
        tilings = ([bg.SKINNY] if m <= bg.FMA_TILES[bg.SKINNY][0]
                   else [bg.WIDE_64, bg.WIDE_128])
        for t in tilings:
            for S in (x for x in F32_SPLIT_COUNTS if x <= -(-k // bg.KSPAN)):
                bg._launch(entry, a, b, c, slices=S, tiling=t)
                rel = float((c - want).abs().max() / want.abs().max())
                check(rel <= 1e-5, f"split f32 {row}: tiling {t}, {S} "
                      f"slices, rel err {rel:.3g}")
                row["ms_by_tiling_slices"][f"{t}/{S}"] = time_ms(
                    lambda: bg._launch(entry, a, b, c, slices=S, tiling=t),
                    hide_host=True)
        bf = b.float()
        row["rule_ms"] = time_ms(lambda: fn(a, b), hide_host=True)
        row["library_ms"] = time_ms(lambda: torch.matmul(a, bf),
                                    hide_host=True)
        emit({"phase": "split", **row})
        del a, b, bf, c, want

    # flash attention's rows a block at the training shape (f32); at MLA's
    # (192, 128) tiles only the sweep's winner, 128 rows, is built
    from repro_torch.kernels import flash_attention as fa
    B, S_, H, K, D = 8, 128, 32, 8, 128
    q = torch.randn((B, H, S_, D), generator=gen, device=dev)
    k_ = torch.randn((B, K, S_, D), generator=gen, device=dev)
    v = torch.randn((B, K, S_, D), generator=gen, device=dev)
    want = fa._attend_plain(q, k_, v, causal=True, window=0, q_offset=0)
    out, row = torch.empty_like(q), {"case": "flash_block_q", "ms": {}}
    for bq in (32, 64, 128):
        fa.attend(q, k_, v, out, _block_q=bq)
        rel = float((out - want).abs().max() / want.abs().max())
        check(rel <= 1e-5, f"flash block_q {bq}: rel err {rel:.3g}")
        row["ms"][bq] = time_ms(
            lambda: fa.attend(q, k_, v, out, _block_q=bq), hide_host=True)
    emit({"phase": "split", "path_block_q": fa.plan(D, D)[2], **row})


def phase_f32sets(moe_cfg):
    """The f32 kernels' sets as the paths run them, by events (``ms``) and
    with the host's gaps hidden (``device_ms``), through calls that every
    tree of the port offers, so that ``--src`` times an older tree beside
    this one: ``ops.block_gemm`` at 512^3; the expert products of one
    full-width MoE decode step as the step calls them (``ops.expert_matmul``
    of f32 capacity buffers against the bf16 weights, no gradient); the
    block GEMM launches of each f32-policy cell's first fleet step, timed
    by :func:`time_band_gemm_set`; ``ops.mha_flash`` at the training shape
    (batch 8, 128 tokens, 32 heads over 8, head dim 128, causal, f32)."""
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"src": os.path.dirname(os.path.dirname(repro_torch.__file__))}

    def both(fn, launches=1):
        return {"launches": launches, "ms": time_ms(fn),
                "device_ms": time_ms(fn, hide_host=True, launches=launches)}

    a = torch.randn((512, 512), generator=gen, device=dev)
    b = torch.randn((512, 512), generator=gen, device=dev)
    out["block_gemm_512"] = both(lambda: ops.block_gemm(a, b))

    experts = [(torch.randn(ash, generator=gen, device=dev),
                (torch.randn(bsh, generator=gen, device=dev)
                 / ash[2] ** 0.5).bfloat16(), n * moe_cfg.n_layers)
               for (ash, bsh), n in sorted(collections.Counter(
                   moe_expert_shapes(moe_cfg, 4, False)).items())]

    def decode_step():
        with torch.no_grad():
            for x, w, n in experts:
                for _ in range(n):
                    ops.expert_matmul(x, w)
    out["moe_decode_step"] = both(decode_step, sum(e[2] for e in experts))

    out["cells"] = {}
    for cell in F32_CELLS:
        _, _, _, params, opt, data, sess, _ = f32_cell(cell)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(0).items()}
        with band_gemm_audit(verify=False) as band, \
                band_gemm_audit(verify=False,
                                entry="block_gemm_batched") as b2:
            sess.step(params, opt, batch)
        out["cells"][cell] = {}
        for name, entry, audit in (
                ("band_gemm", "block_gemm_batched_shared", band),
                ("block_gemm_batched", "block_gemm_batched", b2)):
            if audit["shapes"]:
                t = time_band_gemm_set(audit["shapes"], entry)
                out["cells"][cell][name] = {
                    k: t[k] for k in ("launches", "ms", "device_ms")}
        del params, opt, sess

    B, S, H, K, D = 8, 128, 32, 8, 128
    q = torch.randn((B, S, H, D), generator=gen, device=dev)
    k = torch.randn((B, S, K, D), generator=gen, device=dev)
    v = torch.randn((B, S, K, D), generator=gen, device=dev)
    out["flash_train"] = both(lambda: ops.mha_flash(q, k, v, causal=True))
    emit({"phase": "f32sets", **out})


def phase_attnsets():
    """B5, B6 and B3 at their timed shapes through calls every tree of the
    port offers (``ops.gqa_flash_decode``, ``ops.wkv6``,
    ``ops.gqa_flash_decode_paged``), by events (``ms``) and with the host's
    gaps hidden (``device_ms``), so that ``--src`` times an older tree
    beside this one: B5 at the 32k cell, llama's and granite's serving
    shapes, each in f32 and bf16; B6 at the training, decode and 100-token
    prefill shapes in bf16; B3 at the serving path's shapes (f32 pools),
    the paged 32k cell (f32 and bf16) and its pages of 64 and 256 (bf16;
    a tree whose kernel refuses the shape says so)."""
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {"src": os.path.dirname(os.path.dirname(repro_torch.__file__))}
    for tag, B, S, H, K, D, lengths in DECODE_CASES:
        if tag not in DECODE_TIMED:
            continue
        q, k32, v32, valid = _decode_inputs(dev, gen, B, S, H, K, D,
                                            lengths)
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            k, v = k32.to(dt), v32.to(dt)

            def kernel():
                return ops.gqa_flash_decode(q, k, v, valid)
            out[f"flash_decode_{tag}_{name}"] = {
                "ms": time_ms(kernel, iters=20),
                "device_ms": time_ms(kernel, iters=20, hide_host=True)}
            del k, v
        del q, k32, v32
    for tag, B, S, H, hd, state in WKV_TIMED:
        r, k, v, w, u, s0 = _wkv_inputs(dev, gen, B, S, H, hd,
                                        torch.bfloat16, state)

        def kernel():
            return ops.wkv6(r, k, v, w, u, s0=s0, chunk=32)
        out[f"wkv6_{tag}_bfloat16"] = {
            "ms": time_ms(kernel), "device_ms": time_ms(kernel,
                                                        hide_host=True)}
    for tag, B, K, G, D, page, n_pages, lengths, dts, _ in PAGED_CASES:
        if tag not in PAGED_TIMED:
            continue
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            if name[0] not in dts:
                continue
            q, kp, vp, pt, ln = _paged_case(dev, gen, B, K, G, D, page,
                                            n_pages, lengths, dt)
            qh = q.reshape(B, 1, K * G, D)

            def kernel():
                return ops.gqa_flash_decode_paged(qh, kp, vp, pt, ln)
            try:
                kernel()
            except ValueError as e:      # an older tree's page limit
                out[f"paged_decode_{tag}_{name}"] = {"raises": str(e)}
                continue
            out[f"paged_decode_{tag}_{name}"] = {
                "ms": time_ms(kernel, iters=20),
                "device_ms": time_ms(kernel, iters=20, hide_host=True)}
            del q, kp, vp
    emit({"phase": "attnsets", **out})


@contextlib.contextmanager
def routing_log():
    """Records the expert ids every ``moe.route`` call picks, in call
    order, while the block runs."""
    from repro_torch.models import moe as MOE
    real, log = MOE.route, []

    def logged(cfg, router, xt):
        out = real(cfg, router, xt)
        log.append(out[2].detach())
        return out

    MOE.route = logged
    try:
        yield log
    finally:
        MOE.route = real


@contextlib.contextmanager
def forced_routing(expert_ids):
    """While the block runs, the i-th ``moe.route`` call picks the experts
    ``expert_ids[i]`` (another run's choices) in place of its own top-k,
    with their probabilities renormalised as ``route`` does: the two runs
    then differ in rounding alone, not in discrete routing choices."""
    import torch
    from repro_torch.models import moe as MOE
    real, calls = MOE.route, iter(expert_ids)

    def forced(cfg, router, xt):
        probs, _, _ = real(cfg, router, xt)
        top_e = next(calls)
        top_p = torch.gather(probs, 1, top_e)
        return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e

    MOE.route = forced
    try:
        yield
    finally:
        MOE.route = real


def routing_flip_share(a_log, b_log, n_experts: int) -> float:
    """Share of (token, expert) assignments that one run of the layers
    made and the other did not."""
    import torch
    diff = total = 0
    for a, b in zip(a_log, b_log):
        oa = torch.zeros((a.shape[0], n_experts), device=a.device) \
            .scatter_(1, a, 1.0)
        ob = torch.zeros_like(oa).scatter_(1, b, 1.0)
        diff += float((oa != ob).sum()) / 2
        total += a.numel()
    return diff / max(total, 1)


def first_decode_vs_monolithic(cfg, params, prompts, cache_len,
                               first_logits, serve_routes):
    """A serving session's first decode step against the monolithic path
    on the same inputs: per-request prefill of prompt[:-1] (the session's
    own prefill, the prompt's tokens routed together) into an f32 cache
    of ``cache_len`` slots (the pools' dtype; K/V, or MLA's latent
    ckv/kpe), then one ``decode_step`` of the prompts' last tokens (routed
    together, as the session's step routes them).  Twice: as the
    monolithic path runs, and given the session's expert choices
    (``serve_routes``, the decode step's).  The fleet's router runs on
    bf16-rounded operands (the bf16 policy) and the monolithic one in
    f32, and the hidden states reaching the router differ by bf16
    roundings too, so an expert whose probability lies within rounding of
    the k-th may flip; with 4 tokens one flip moves the logits by about a
    percent.  The forced run holds the rest of the step to the serving
    bar; the free one is reported."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    slots, P = len(prompts), len(prompts[0])
    cache = {}
    for b, p in enumerate(prompts):
        _, pc = M.prefill(cfg, params, {"tokens": torch.as_tensor(
            p[None, :P - 1].astype(np.int64), device=dev)})
        for nm, t in pc.items():
            if nm == "pos":
                continue
            if nm not in cache:
                cache[nm] = torch.zeros((t.shape[0], slots, cache_len)
                                        + tuple(t.shape[3:]), device=dev)
            cache[nm][:, b, :P - 1] = t[:, 0].float()
    cache["pos"] = torch.full((slots,), P - 1, dtype=torch.int32, device=dev)
    toks = torch.as_tensor(np.stack([p[-1:] for p in prompts])
                           .astype(np.int64), device=dev)
    V = cfg.vocab_size
    cmp = {}
    for tag, ctx in (("as_run", contextlib.nullcontext),
                     ("same_routing",
                      lambda: forced_routing(serve_routes))):
        with routing_log() as routes, ctx():
            ref_logits, _ = M.decode_step(cfg, params, cache, toks)
        diff = (first_logits[..., :V] - ref_logits[..., :V]).float()
        cmp[tag] = {
            "rel_l2": float(diff.norm() / ref_logits[..., :V].float().norm()),
            "argmax_equal": bool((first_logits[..., :V].argmax(-1)
                                  == ref_logits[..., :V].argmax(-1)).all()),
            "routing_flip_share": routing_flip_share(routes, serve_routes,
                                                     cfg.n_experts)}
    return cmp


# the routed-expert f32 cells: (forward fleet GEMMs of a step, GEMMs of a
# step); the failure strikes at the third GEMM of the backward
MOE_CELLS = {"moe_reduced": (12, 36),    # q, k, v, o, router x 2 + 2 head
             "mla_reduced": (22, 66)}    # 10 a layer x 2 + 2 head chunks


def phase_moe_reduced(cell: str = "moe_reduced"):
    """Routed-expert fleet training (f32 policy) against the monolithic
    step: 3 steps, device 2 failing in the backward of step 1; then fleet
    serving against token-by-token monolithic decoding.  ``cell``:
    granite-moe-1b-a400m's (K/V pools, the paged read checked every step)
    or deepseek-v2-236b's (MLA: flash attention at Dk 48 / Dv 32, the
    latent ckv/kpe pools, the paged read skipped as the reference skips
    it)."""
    import numpy as np
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_train_step
    dev = torch.device("cuda")
    cfg, chunks, opt_cfg, params, opt, data, sess, ctl = f32_cell(cell)
    n_fwd, n_gemms = MOE_CELLS[cell]
    mono = make_train_step(cfg, opt_cfg, **chunks)
    p_f, o_f, p_m, o_m, p_c, o_c = params, opt, params, opt, params, opt
    rows, audits, b2_audits = [], [], []
    for step in range(3):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        fail = dict(fail_ids=[2] if step == 1 else (), fail_at_gemm=n_fwd + 2)
        p_m, o_m, met_m = mono(p_m, o_m, batch)
        n_fa = fa.launches
        with band_gemm_audit(verify=True) as audit, \
                band_gemm_audit(verify=True,
                                entry="block_gemm_batched") as audit2:
            mark = residual_mark()
            p_f, o_f, met_f = sess.step(p_f, o_f, batch, **fail)
            res = residual_since(mark, cell, met_f["fleet"])
        audits.append(audit)
        b2_audits.append(audit2)
        n_fa = fa.launches - n_fa
        p_c, o_c, _ = ctl.step(p_c, o_c, batch, **fail)
        rep = met_f["fleet"]
        lm, lf = float(met_m["loss"]), float(met_f["loss"])
        gm, gf = float(met_m["grad_norm"]), float(met_f["grad_norm"])
        am, af = float(met_m["aux_loss"]), float(met_f["aux_loss"])
        rows.append({"step": step, "loss_fleet": lf, "loss_mono": lm,
                     "loss_rel": abs(lf - lm) / abs(lm),
                     "aux_fleet": af, "aux_rel": abs(af - am) / abs(am),
                     "grad_norm_rel": abs(gf - gm) / abs(gm),
                     "n_gemms": rep.n_gemms, "verified": rep.verified,
                     "n_recovered": rep.n_recovered,
                     "failed_ids": list(rep.failed_ids),
                     **res,
                     "band_gemm_checked": audit["checked"],
                     "bgemm_checked": audit2["checked"],
                     "bgemm_max_rel_err": audit2["max_rel_err"],
                     "flash_launches": n_fa})
    worst = {"params": _worst_rel(p_m, p_f), "mu": _worst_rel(o_m.mu, o_f.mu),
             "nu": _worst_rel(o_m.nu, o_f.nu),
             "params_l2": _worst_rel(p_m, p_f, norm=2),
             "control_bf16_params_l2": _worst_rel(p_m, p_c, norm=2)}

    # serving: the session prefills prompt[:-1] in one call and decodes the
    # slots together, the monolithic path decodes token by token; the two
    # route different token sets together, so they agree only without
    # capacity drops (capacity factor 32, as the reference's tests do)
    cfg32 = dataclasses.replace(cfg, capacity_factor=32.0)
    rt = TorchCleaveRuntime(arch=cfg32, fleet=Fleet.sample(8, seed=0),
                            device=dev)
    serve = rt.serve_session(p_f, slots=3, page_size=4, max_len=16,
                             backend="torch", dtype_policy="f32",
                             check_paged_read=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
               for _ in range(3)]
    for p in prompts:
        serve.submit(p, max_new=4)
    n_b2 = bg.batched_launches
    srep = serve.run(fail_ids=[2], fail_at_step=1)
    serve_b2 = bg.batched_launches - n_b2
    got = {r.rid: r.tokens for r in serve.batcher.finished}
    want = {i: _monolithic_greedy(cfg32, p_f, p, 4, 16, dev)
            for i, p in enumerate(prompts)}
    serve_ok = all(s.verified for s in serve.step_reports)
    out = {"bodies": check_bodies(cell, *audits, *b2_audits),
           "band_gemm_step": time_band_gemm_set(audits[0]["shapes"]),
           "bgemm_step": time_band_gemm_set(b2_audits[0]["shapes"],
                                            entry="block_gemm_batched")}
    emit({"phase": cell, "steps": rows, "worst_rel": worst, **out,
          "params_l2_limit": TRAIN_PARAMS_L2_LIMIT,
          "serve_tokens_match": got == want, "serve_verified": serve_ok,
          "serve_recovered": srep.n_recovered,
          "serve_pools": sorted(serve.kv.pools),
          "serve_paged_read_checks": serve.paged_read_checks,
          "serve_steps": srep.n_steps, "serve_bgemm_launches": serve_b2})
    for r in rows:
        check(r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4
              and r["aux_rel"] <= 1e-4,
              f"{cell} step {r['step']}: loss/aux/grad_norm off {r}")
        check(r["verified"] and r["n_gemms"] == n_gemms,
              f"{cell} step {r['step']}: unverified or GEMMs {r}")
        check(r["band_gemm_checked"] > 0 and r["bgemm_checked"] > 0
              and r["flash_launches"] == cfg.n_layers,
              f"{cell} step {r['step']}: a kernel was not launched {r}")
    check(max(worst["mu"], worst["nu"]) <= 1e-4,
          f"{cell}: moments off {worst}")
    check(worst["params_l2"] <= TRAIN_PARAMS_L2_LIMIT,
          f"{cell}: params off {worst}")
    check(worst["control_bf16_params_l2"] > TRAIN_PARAMS_L2_LIMIT,
          f"{cell}: the bf16 control passed the params check {worst}")
    check(rows[1]["n_recovered"] > 0 and rows[1]["failed_ids"] == [2],
          f"{cell}: the failure recovered nothing")
    check(got == want, f"{cell}: served tokens {got} != monolithic {want}")
    # the reference reads MLA's latent pools with no paged check
    pools, checks = ((["ckv", "kpe"], 0) if cfg.mla
                     else (["k", "v"], srep.n_steps))
    check(serve_ok and srep.n_recovered > 0 and serve_b2 > 0
          and sorted(serve.kv.pools) == pools
          and serve.paged_read_checks == checks,
          f"{cell}: serving unverified, unrecovered or its pools or paged "
          "checks not the family's")
    return out


def phase_moe_full(cfg):
    """granite-moe-1b-a400m at full width: 3 fleet training steps, device 3
    failing at GEMM 30 (in the backward) of step 1, the first step against
    the monolithic path; then fleet serving with a failure at step 2."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    dev = torch.device("cuda")
    B, S, n_steps = 8, 128, 3
    chunks = dict(q_chunk=64, k_chunk=64, loss_chunk=64)
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=3, total_steps=n_steps)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in T.leaves(params))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step).items()}
               for step in range(n_steps)]
    t0 = time.perf_counter()
    with routing_log() as mono_routes:
        (loss_m, met_m), grads = M.value_and_grad(cfg, params, batches[0],
                                                  **chunks)
    gnorm_m = float(adam.global_norm(grads))
    del grads
    torch.cuda.synchronize()
    t_mono = time.perf_counter() - t0

    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # PS-local GEMMs
        sess = rt.train_session(opt_cfg, backend="torch",
                                dtype_policy="bf16", **chunks)
    rows, audits, b1_audits = [], [], []
    bg.batched_launches = 0
    bg.launches = 0
    reset_body_counts()
    torch.cuda.reset_peak_memory_stats()
    for step, batch in enumerate(batches):
        n_b2, n_b1 = bg.batched_launches, bg.launches
        # 22 forward fleet GEMMs per step: GEMM 30 is in the backward
        with routing_log() as routes, band_gemm_audit(
                verify=True, entry="block_gemm_batched") as audit, \
                band_gemm_audit(verify=False) as b1_audit:
            mark = residual_mark()
            params, opt, met = sess.step(
                params, opt, batch, fail_ids=[3] if step == 1 else (),
                fail_at_gemm=30)
            res = residual_since(mark, "moe_full", met["fleet"])
        audits.append(audit)
        b1_audits.append(b1_audit)
        if step == 0:
            flip = routing_flip_share(mono_routes, routes, cfg.n_experts)
        rep = met["fleet"]
        kinds = collections.Counter(r.kind for r in rep.records)
        rows.append({
            "step": step, "loss": rep.loss, "aux_loss":
                float(met["aux_loss"]), "grad_norm": rep.grad_norm,
            "wall_s": rep.wall_time, "fleet_exec_s": rep.fleet_exec_time,
            "n_gemms": rep.n_gemms, "gemms_by_kind": dict(kinds),
            "n_tasks": rep.n_tasks, "n_recovered": rep.n_recovered,
            "failed_ids": list(rep.failed_ids), "verified": rep.verified,
            "bgemm_launches": bg.batched_launches - n_b2,
            "bgemm_checked_against_plain": audit["checked"],
            "bgemm_max_rel_err": audit["max_rel_err"],
            "band_gemm_launches": bg.launches - n_b1, **res})
        emit({"phase": "moe_full_step", **rows[-1]})
    torch.cuda.synchronize()
    train_b2 = bg.batched_launches
    train_bodies = check_bf16_body("moe_full training", *audits, *b1_audits)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(rows[0]["loss"] - float(loss_m)) / abs(float(loss_m))
    gnorm_rel = abs(rows[0]["grad_norm"] - gnorm_m) / abs(gnorm_m)
    step_shapes = collections.Counter((a, b) for a, b, _ in
                                      audits[0]["shapes"])
    want_shapes = collections.Counter(
        moe_expert_shapes(cfg, B * S, True) * cfg.n_layers)
    del opt, met, batches

    # serving: 4 slots, prompts of 16, 8 new tokens, device 3 failing at
    # the session's step 2, the paged read checked every step
    slots, P, n_gen, page = 4, 16, 8, 16
    rt2 = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                             device=dev)
    serve = rt2.serve_session(params, slots=slots, page_size=page,
                              max_len=P + n_gen, backend="torch",
                              dtype_policy="bf16", check_paged_read=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, P).astype(np.int32)
               for _ in range(slots)]
    for p in prompts:
        serve.submit(p, max_new=n_gen)
    n_b2 = bg.batched_launches
    dec.launches = dec.paged_element_launches = 0
    reset_body_counts()
    t0 = time.perf_counter()
    with band_gemm_audit(verify=True, entry="block_gemm_batched") as saudit, \
            band_gemm_audit(verify=False) as sb1_audit:
        with routing_log() as serve_routes:
            first = serve.step()
        first_logits = serve.last_logits.clone()
        srep = serve.run(fail_ids=[3], fail_at_step=1)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    serve_b2 = bg.batched_launches - n_b2
    paged = {"fast": dec.launches - dec.paged_element_launches,
             "element": dec.paged_element_launches}
    serve_bodies = check_bf16_body("moe_full serving", saudit, sb1_audit)
    # every decode step's expert product met the bf16 weights as stored
    # (no f32 copy), with the bits of the launch on an f32 copy; prefills
    # run bf16 throughout
    check(saudit["mixed"] == saudit["by_dtype"]["float32"]
          == saudit["mixed_bitwise_equal_promoted"] > 0,
          f"moe_full serving: {saudit['mixed']} f32 x bf16 expert launches "
          f"({saudit['mixed_bitwise_equal_promoted']} equal to the promoted "
          f"launch) of {dict(saudit['by_dtype'])}")

    # the first decode step against the monolithic path (the decode's
    # routing choices, not the prefills')
    cmp = first_decode_vs_monolithic(cfg, params, prompts, serve.cache_len,
                                     first_logits,
                                     serve_routes[-cfg.n_layers:])
    rel_l2 = cmp["same_routing"]["rel_l2"]
    n_steps = srep.n_steps
    row = {"phase": "moe_full", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "top_k": cfg.moe_top_k, "moe_d_ff": cfg.moe_d_ff,
           "vocab": cfg.vocab_size, "n_params": n_params, "batch": B,
           "seq": S, "param_init_s": t_init, "mono_grad_s": t_mono,
           "loss_mono": float(loss_m), "aux_loss_mono":
               float(met_m["aux_loss"]), "grad_norm_mono": gnorm_m,
           "first_step_loss_rel": loss_rel,
           "first_step_grad_norm_rel": gnorm_rel,
           "first_step_routing_flip_share": flip,
           "max_memory_allocated_gb": peak_gb,
           "bgemm_launches_training": train_b2,
           "block_gemm_bodies_training": train_bodies,
           "block_gemm_bodies_serving": serve_bodies,
           "bgemm_bf16_launches_training": sum(
               a["by_dtype"]["bfloat16"] for a in audits),
           "bgemm_bf16_launches_serving": saudit["by_dtype"]["bfloat16"],
           "bgemm_f32_x_bf16_launches_serving": saudit["mixed"],
           "bgemm_step_shapes_as_timed": step_shapes == want_shapes,
           "serve_s": t_serve, "n_steps": n_steps, "n_tokens":
               srep.n_tokens, "tokens_per_s": srep.tokens_per_sec,
           "gemms_per_decode_step": len(first.records),
           "serve_all_verified": all(s.verified
                                     for s in serve.step_reports),
           "serve_failed_ids": list(srep.failed_ids),
           "serve_recovered": srep.n_recovered,
           "paged_read_checks": serve.paged_read_checks,
           "paged_decode_by_route": paged,
           "bgemm_launches_serving": serve_b2,
           "bgemm_serving_checked_against_plain": saudit["checked"],
           "first_decode_vs_monolithic": cmp}
    emit(row)
    for r in rows:
        check(r["verified"], f"moe_full step {r['step']}: unverified")
        fwd = r["n_gemms"] // 3
        check(r["gemms_by_kind"] == {"fwd": fwd, "dA": fwd, "dW": fwd}
              and fwd == 5 * cfg.n_layers + S // chunks["loss_chunk"],
              f"moe_full step {r['step']}: GEMM kinds {r['gemms_by_kind']}")
        check(r["bgemm_launches"] == 9 * cfg.n_layers
              and r["bgemm_checked_against_plain"] == r["bgemm_launches"]
              and r["band_gemm_launches"] > 0,
              f"moe_full step {r['step']}: kernel launches {r}")
        check(bool(np.isfinite(r["loss"])), f"moe_full step {r['step']}: "
              f"loss {r['loss']}")
    check(rows[1]["failed_ids"] == [3] and rows[1]["n_recovered"] > 0,
          "moe_full: the failure did not fire or recovered nothing")
    check(row["bgemm_step_shapes_as_timed"],
          f"moe_full: step 0's batched GEMM shapes {dict(step_shapes)} are "
          f"not the set bgemm timed")
    # every GEMM output is rounded to bf16, in another order on each path;
    # the fleet's router runs on bf16 operands, the monolithic one in f32,
    # so a few routing choices may differ (the flip share is printed above)
    check(loss_rel <= 1e-2, f"moe_full: first-step loss rel {loss_rel} "
          f"(routing flip share {flip:.3g})")
    check(gnorm_rel <= 5e-2, f"moe_full: first-step grad_norm rel "
          f"{gnorm_rel} (routing flip share {flip:.3g})")
    check(row["serve_all_verified"] and srep.failed_ids == (3,)
          and srep.n_recovered > 0,
          "moe_full: serving unverified, or the failure did not recover")
    check(serve.paged_read_checks == n_steps, "moe_full: paged read checks "
          f"{serve.paged_read_checks} != steps {n_steps}")
    check(paged == {"fast": n_steps, "element": 0}, f"moe_full: paged "
          f"decode launches {paged} in {n_steps} steps")
    check(train_b2 > 0 and serve_b2 > 0
          and saudit["checked"] == serve_b2,
          f"moe_full: batched GEMM launches training {train_b2}, serving "
          f"{serve_b2}")
    # the serving bar of the full cell (bf16 roundings in another order),
    # against the monolithic decode given the same routing choices
    check(rel_l2 <= 2e-2, f"moe_full: first decode step's logits rel L2 "
          f"{rel_l2} against the monolithic decode with the same routing "
          f"{cmp}")
    return {"training": train_b2, "serving": serve_b2,
            "paged_decode": paged["fast"],
            "max_abs_err": max(a["max_abs_err"] for a in audits + [saudit]),
            "bodies": body_counts(*audits, saudit)}


def check_gemm_set(shapes, entry: str = "block_gemm_batched_shared"):
    """Each distinct (A, B, type) of a recorded launch set, on fresh
    operands of its shape, held against the plain version (1e-5 relative
    of the largest output); returns the worst absolute and relative
    errors.  For a path whose own launches are too large to hold against
    the plain version in place (mla_full's training step: the plain
    version of a 160-expert dW product needs 10 GB beside the step).
    Where the two differ by more, both are held against the f64 product
    of the same operands: the kernel must lie within 1e-5 of it and no
    further from it than the plain version (whose f32 sums drift at
    contractions of 10^5, the LM head's dA over the vocabulary)."""
    import torch
    from repro_torch.kernels import block_gemm as bg
    kernel, plain = getattr(bg, entry), getattr(bg, entry + "_plain")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0, "distinct": 0}
    saved = {n: getattr(bg, n) for n in BLOCK_GEMM_COUNTERS}
    for ash, bsh, dt in sorted(set(shapes)):
        k = ash[-1]
        a = torch.randn(ash, generator=gen, device=dev).to(getattr(torch, dt))
        b = (torch.randn(bsh, generator=gen, device=dev) / k ** 0.5) \
            .to(getattr(torch, dt))
        c = kernel(a, b)
        want = plain(a, b)
        err = float((c - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        if rel > 1e-5:
            exact = torch.matmul(a.double(), b.double())
            scale = float(exact.abs().max())
            k_err = float((c.double() - exact).abs().max()) / scale
            p_err = float((want.double() - exact).abs().max()) / scale
            del exact
            emit({"phase": "gemm_set_f64", "a": list(ash), "b": list(bsh),
                  "dtype": dt, "rel_err_vs_plain": rel,
                  "kernel_rel_err_vs_f64": k_err,
                  "plain_rel_err_vs_f64": p_err})
            check(k_err <= 1e-5 and k_err <= p_err,
                  f"{entry} at {ash} x {bsh} {dt}: rel err {rel:.3g} "
                  f"against the plain version; against f64 the kernel "
                  f"{k_err:.3g}, the plain version {p_err:.3g}")
            worst["f64_held"] = worst.get("f64_held", 0) + 1
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_rel_err"] = max(worst["max_rel_err"], rel)
        worst["distinct"] += 1
        del a, b, c, want
    for n, v in saved.items():       # these launches are not the path's
        setattr(bg, n, v)
    return worst


def phase_mla_full(cfg):
    """deepseek-v2-236b at full width and one layer: 3 donated fleet
    training steps, device 3 failing in step 1's backward, the first step
    against the monolithic path; the step's band GEMM and batched block
    GEMM launch sets held against their plain versions and timed; then
    fleet serving from the latent pools with a failure at step 2, the
    first decode step against the monolithic ``decode_step`` given the
    session's routing."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    dev = torch.device("cuda")
    B, S, n_steps = 8, 128, 3
    chunks = dict(q_chunk=64, k_chunk=64, loss_chunk=64)
    # 12 forward fleet GEMMs a step (10 of the layer, 2 LM-head chunks):
    # GEMM 20 is in the backward
    fail_at = 20
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=3, total_steps=n_steps)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in T.leaves(params))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step).items()}
               for step in range(n_steps)]
    # the monolithic path first, before the moments exist: params, grads
    # and moments together would not leave room for it
    t0 = time.perf_counter()
    with routing_log() as mono_routes:
        (loss_m, met_m), grads = M.value_and_grad(cfg, params, batches[0],
                                                  **chunks)
    gnorm_m = float(adam.global_norm(grads, sliced=True))
    del grads
    torch.cuda.synchronize()
    t_mono = time.perf_counter() - t0
    opt = adam.init(params, opt_cfg)

    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # PS-local GEMMs
        sess = rt.train_session(opt_cfg, backend="torch",
                                dtype_policy="bf16", **chunks)
    rows, audits, b1_audits = [], [], []
    bg.batched_launches = bg.launches = fa.launches = 0
    reset_body_counts()
    torch.cuda.reset_peak_memory_stats()
    for step, batch in enumerate(batches):
        n_b2, n_b1, n_fa = bg.batched_launches, bg.launches, fa.launches
        with routing_log() as routes, band_gemm_audit(
                verify=False, entry="block_gemm_batched") as audit, \
                band_gemm_audit(verify=False) as b1_audit:
            mark = residual_mark()
            params, opt, met = sess.step(
                params, opt, batch, fail_ids=[3] if step == 1 else (),
                fail_at_gemm=fail_at, donate=True)
            res = residual_since(mark, "mla_full", met["fleet"])
        audits.append(audit)
        b1_audits.append(b1_audit)
        if step == 0:
            flip = routing_flip_share(mono_routes, routes, cfg.n_experts)
        rep = met["fleet"]
        kinds = collections.Counter(r.kind for r in rep.records)
        rows.append({
            "step": step, "loss": rep.loss, "aux_loss":
                float(met["aux_loss"]), "grad_norm": rep.grad_norm,
            "wall_s": rep.wall_time, "fleet_exec_s": rep.fleet_exec_time,
            "n_gemms": rep.n_gemms, "gemms_by_kind": dict(kinds),
            "n_tasks": rep.n_tasks, "n_recovered": rep.n_recovered,
            "failed_ids": list(rep.failed_ids), "verified": rep.verified,
            "bgemm_launches": bg.batched_launches - n_b2,
            "band_gemm_launches": bg.launches - n_b1,
            "flash_launches": fa.launches - n_fa, **res})
        emit({"phase": "mla_full_step", **rows[-1]})
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train = {"bgemm": bg.batched_launches, "band_gemm": bg.launches,
             "flash_attention": fa.launches,
             "bodies": check_bf16_body("mla_full training", *audits,
                                       *b1_audits)}
    loss_rel = abs(rows[0]["loss"] - float(loss_m)) / abs(float(loss_m))
    gnorm_rel = abs(rows[0]["grad_norm"] - gnorm_m) / abs(gnorm_m)
    step_shapes = collections.Counter((a, b) for a, b, _ in
                                      audits[0]["shapes"])
    want_shapes = collections.Counter(
        moe_expert_shapes(cfg, B * S, True) * cfg.n_layers)
    del opt, met, batches
    torch.cuda.empty_cache()
    # the first step's launch sets on fresh operands of their shapes:
    # held against the plain versions, then timed beside their bounds
    sets = {"band_gemm_step": (b1_audits[0]["shapes"],
                               "block_gemm_batched_shared"),
            "bgemm_step": (audits[0]["shapes"], "block_gemm_batched")}
    timed = {}
    for key, (shapes, entry) in sets.items():
        errs = check_gemm_set(shapes, entry)
        timed[key] = {**time_band_gemm_set(shapes, entry), **errs}
        emit({"phase": "mla_full_set", "set": key, **timed[key]})

    # serving: 4 slots, prompts of 16, 8 new tokens, device 3 failing at
    # the session's step 2; the paged read is asked for and, as in the
    # reference, skipped for the latent pools (no paged decode launch)
    slots, P, n_gen, page = 4, 16, 8, 16
    rt2 = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                             device=dev)
    serve = rt2.serve_session(params, slots=slots, page_size=page,
                              max_len=P + n_gen, backend="torch",
                              dtype_policy="bf16", check_paged_read=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, P).astype(np.int32)
               for _ in range(slots)]
    for p in prompts:
        serve.submit(p, max_new=n_gen)
    n_b2, n_b1, n_fa = bg.batched_launches, bg.launches, fa.launches
    dec.launches = dec.paged_element_launches = dec.flash_decode_launches = 0
    reset_body_counts()
    t0 = time.perf_counter()
    with band_gemm_audit(verify=True, entry="block_gemm_batched") as saudit, \
            band_gemm_audit(verify=True) as sb1_audit:
        with routing_log() as serve_routes:
            first = serve.step()
        first_logits = serve.last_logits.clone()
        srep = serve.run(fail_ids=[3], fail_at_step=1)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    serving = {"bgemm": bg.batched_launches - n_b2,
               "band_gemm": bg.launches - n_b1,
               "flash_attention": fa.launches - n_fa,
               "paged_decode": dec.launches,
               "flash_decode": dec.flash_decode_launches,
               "bodies": check_bf16_body("mla_full serving", saudit,
                                         sb1_audit)}

    # the first decode step against the monolithic path (the decode's
    # routing choices, not the prefills')
    cmp = first_decode_vs_monolithic(cfg, params, prompts, serve.cache_len,
                                     first_logits,
                                     serve_routes[-cfg.n_layers:])
    rel_l2 = cmp["same_routing"]["rel_l2"]
    n_steps = srep.n_steps
    row = {"phase": "mla_full", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "qk_dim": cfg.head_dim + cfg.rope_head_dim, "v_dim": cfg.v_dim,
           "kv_lora_rank": cfg.kv_lora_rank, "q_lora_rank": cfg.q_lora_rank,
           "n_experts": cfg.n_experts, "top_k": cfg.moe_top_k,
           "n_shared_experts": cfg.n_shared_experts,
           "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size,
           "n_params": n_params, "batch": B, "seq": S,
           "param_init_s": t_init, "mono_grad_s": t_mono,
           "loss_mono": float(loss_m), "aux_loss_mono":
               float(met_m["aux_loss"]), "grad_norm_mono": gnorm_m,
           "first_step_loss_rel": loss_rel,
           "first_step_grad_norm_rel": gnorm_rel,
           "first_step_routing_flip_share": flip,
           "max_memory_allocated_gb": peak_gb,
           "launches_training": train, "launches_serving": serving,
           "bgemm_step_shapes_as_timed": step_shapes == want_shapes,
           "serve_s": t_serve, "n_steps": n_steps, "n_tokens":
               srep.n_tokens, "tokens_per_s": srep.tokens_per_sec,
           "gemms_per_decode_step": len(first.records),
           "serve_all_verified": all(s.verified
                                     for s in serve.step_reports),
           "serve_failed_ids": list(srep.failed_ids),
           "serve_recovered": srep.n_recovered,
           "serve_pools": sorted(serve.kv.pools),
           "paged_read_checks": serve.paged_read_checks,
           "bgemm_serving_checked_against_plain": saudit["checked"],
           "band_gemm_serving_checked_against_plain": sb1_audit["checked"],
           "first_decode_vs_monolithic": cmp}
    emit(row)
    for r in rows:
        check(r["verified"], f"mla_full step {r['step']}: unverified")
        fwd = r["n_gemms"] // 3
        check(r["gemms_by_kind"] == {"fwd": fwd, "dA": fwd, "dW": fwd}
              and fwd == 10 * cfg.n_layers + S // chunks["loss_chunk"],
              f"mla_full step {r['step']}: GEMM kinds {r['gemms_by_kind']}")
        check(r["bgemm_launches"] == 9 * cfg.n_layers
              and r["band_gemm_launches"] > 0
              and r["flash_launches"] == cfg.n_layers,
              f"mla_full step {r['step']}: kernel launches {r}")
        check(bool(np.isfinite(r["loss"])), f"mla_full step {r['step']}: "
              f"loss {r['loss']}")
    check(rows[1]["failed_ids"] == [3] and rows[1]["n_recovered"] > 0,
          "mla_full: the failure did not fire or recovered nothing")
    check(row["bgemm_step_shapes_as_timed"],
          f"mla_full: step 0's batched GEMM shapes {dict(step_shapes)}")
    check(peak_gb < 80.0, f"mla_full: peak memory {peak_gb} GB")
    # every GEMM output is rounded to bf16, in another order on each path;
    # the fleet's router runs on bf16 operands, the monolithic one in f32,
    # so a few routing choices may differ (the flip share is printed above)
    check(loss_rel <= 1e-2, f"mla_full: first-step loss rel {loss_rel} "
          f"(routing flip share {flip:.3g})")
    check(gnorm_rel <= 5e-2, f"mla_full: first-step grad_norm rel "
          f"{gnorm_rel} (routing flip share {flip:.3g})")
    check(row["serve_all_verified"] and srep.failed_ids == (3,)
          and srep.n_recovered > 0,
          "mla_full: serving unverified, or the failure did not recover")
    # the reference's paged-read check returns for MLA: no paged decode
    # launch, no check counted; the absorbed decode is einsums, so no
    # flash-decode launch either
    check(serve.paged_read_checks == 0 and serving["paged_decode"] == 0
          and serving["flash_decode"] == 0,
          f"mla_full: paged or flash decode ran on latent pools {serving}")
    check(serving["flash_attention"] == slots * cfg.n_layers
          and serving["bgemm"] > 0 and serving["band_gemm"] > 0
          and saudit["checked"] == serving["bgemm"]
          and sb1_audit["checked"] == serving["band_gemm"],
          f"mla_full: serving launches {serving}")
    check(rel_l2 <= 2e-2, f"mla_full: first decode step's logits rel L2 "
          f"{rel_l2} against the monolithic decode with the same routing "
          f"{cmp}")
    return {"training": train, "serving": serving, "sets": timed,
            "max_abs_err": max(
                [timed[k]["max_abs_err"] for k in timed]
                + [saudit["max_abs_err"], sb1_audit["max_abs_err"]])}


# --------------------------------------------- M-RoPE and encoder-decoder --

def family_batch(cfg, data, step, dev, grid=None):
    """A training batch of ``data`` with the stubbed frontends' inputs the
    reference's driver makes (``modality_stubs``: seq // 4 patch
    embeddings a row, or 2 x seq encoder frames) and, for M-RoPE, the
    patches on a ``grid`` at t = 0 with the text after it
    (``grid_positions``), on the card."""
    import torch
    from repro_torch.data.pipeline import grid_positions, modality_stubs
    B, S = data.cfg.global_batch, data.cfg.seq_len
    raw = data.batch(step)
    raw.update(modality_stubs(cfg, B, S, step))
    if cfg.m_rope:
        raw["positions_mrope"] = grid_positions(B, S, grid)
    return {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}


def fleet_kinds(cfg, n_chunks: int) -> dict:
    """The fleet GEMMs of one training step by kind, as the reference runs
    them: 7 a layer (q, k, v, o, gate, up, down), and for the
    encoder-decoder 6 more a decoder layer (the cross k and v over the
    encoder output, and q and the discarded k and v of the decoder
    stream, whose 2 have no backward) and 6 a layer of the encoder's
    recompute in the backward (q, k, v, o, gate, up); the LM head once a
    loss chunk."""
    L_ = cfg.n_layers
    if not cfg.enc_dec:
        n = 7 * L_ + n_chunks
        return {"fwd": n, "dA": n, "dW": n}
    Le = cfg.n_enc_layers
    back = 7 * Le + 11 * L_ + n_chunks
    return {"fwd": 13 * Le + 13 * L_ + n_chunks, "dA": back, "dW": back}


def flash_per_step(cfg) -> int:
    """Flash-attention launches of one training step: one a layer's
    attention, and for the encoder-decoder the encoder's twice (its
    recompute) and each decoder layer's cross-attention."""
    if cfg.enc_dec:
        return 2 * cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def encdec_serve(cfg, params, toks, feats, n_new):
    """The encoder-decoder's monolithic serving path: the cross K/V of
    ``feats`` and one prefill of ``toks`` over them
    (``encdec.decode_cache``), then ``n_new`` - 1 greedy decode steps.
    Returns (the ``n_new`` tokens, the first decode step's logits)."""
    import torch
    from repro_torch.models import encdec as ED
    from repro_torch.models import model as M
    V = cfg.vocab_size
    lg, cache = ED.decode_cache(cfg, params, toks, feats,
                                toks.shape[1] + n_new)
    tok = lg[:, -1:, :V].argmax(-1)
    out, firsts = [tok], []
    with torch.no_grad():
        for _ in range(n_new - 1):
            lg, cache = M.decode_step(cfg, params, cache, tok)
            firsts.append(lg)
            tok = lg[:, -1:, :V].argmax(-1)
            out.append(tok)
    return torch.cat(out, 1), firsts[0]


def encdec_references(cfg, params, toks, feats, first_tok, n_new, dev):
    """Two other paths to what :func:`encdec_serve` gives: the last row of
    a forward over the prompt and ``first_tok`` (the first decode step's
    logits), and token-by-token decoding from an empty cache (its
    ``n_new`` greedy tokens and its logits after ``first_tok``)."""
    import torch
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    V = cfg.vocab_size
    B, P = toks.shape
    with torch.no_grad():
        x, _, _ = M.forward(cfg, params, {
            "tokens": torch.cat([toks, first_tok], 1),
            "encoder_feats": feats})
        fwd_last = L.lm_logits(M._head(params), params["embed"],
                               x[:, -1:], cfg).float()
        cache = M.init_cache(cfg, B, P + n_new, enc_len=feats.shape[1],
                             device=dev)
        cache["cross_k"], cache["cross_v"] = ED.prepare_cross_cache(
            cfg, params, feats)
        tbt = []
        for t in range(P + n_new - 1):
            nxt = toks[:, t:t + 1] if t < P else tbt[-1]
            lg, cache = M.decode_step(cfg, params, cache, nxt)
            if t == P:
                first_tbt = lg
            if t >= P - 1:
                tbt.append(lg[:, -1:, :V].argmax(-1))
    return torch.cat(tbt, 1), first_tbt, fwd_last


def _encdec_compare(cfg, got, first, ref):
    """The serving path's tokens and first decode logits against
    :func:`encdec_references`' (relative L2 over the real vocabulary)."""
    import torch
    want, first_tbt, fwd_last = ref
    V = cfg.vocab_size

    def rel(a, b):
        return float((a - b)[..., :V].float().norm()
                     / b[..., :V].float().norm())
    return {"rel_l2": rel(first, fwd_last),
            "vs_token_by_token_rel_l2": rel(first, first_tbt),
            "tokens_match_token_by_token": bool(torch.equal(got, want))}


def hybrid_serve(cfg, params, toks, n_new):
    """The hybrid's monolithic serving path as ``launch/serve.py`` runs it:
    one prefill of ``toks`` into its cache (``prefill_cache``:
    the prompt's K/V, the SSM state left at zero as the reference's
    prefill leaves it), then ``n_new`` - 1 greedy decode steps.  Returns
    (the ``n_new`` tokens, the last step's logits, whether the prefill
    left the SSM state at zero)."""
    import torch
    from repro_torch.launch.serve import prefill_cache
    from repro_torch.models import model as M
    V = cfg.vocab_size
    with torch.no_grad():
        lg, cache = prefill_cache(cfg, params, toks,
                                  toks.shape[1] + n_new)
        zero = not (bool(cache["ssm_h"].any())
                    or bool(cache["ssm_conv"].any()))
        tok = lg[:, -1:, :V].argmax(-1)
        out = [tok]
        for _ in range(n_new - 1):
            lg, cache = M.decode_step(cfg, params, cache, tok)
            tok = lg[:, -1:, :V].argmax(-1)
            out.append(tok)
    return torch.cat(out, 1), lg, zero


def hybrid_token_by_token(cfg, params, toks, dev):
    """The hybrid's decode held to a forward: ``toks`` (B, P) decoded one
    at a time from an empty cache, the SSM state carried step to step,
    and the last logits against the last row of a forward over the same
    tokens (relative L2 over the real vocabulary).  The prefill path is
    not compared: the reference's prefill leaves the SSM state at zero
    (ROADMAP C), and the port mirrors it."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    V = cfg.vocab_size
    B, P = toks.shape
    with torch.no_grad():
        x, _, _ = M.forward(cfg, params, {"tokens": toks})
        fwd_last = L.lm_logits(M._head(params), params["embed"],
                               x[:, -1:], cfg).float()
        cache = M.init_cache(cfg, B, P, device=dev)
        for t in range(P):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, t:t + 1])
    diff = (lg[..., :V] - fwd_last[..., :V]).float()
    return {"rel_l2": float(diff.norm() / fwd_last[..., :V].norm()),
            "argmax_equal": bool((lg[..., :V].argmax(-1)
                                  == fwd_last[..., :V].argmax(-1)).all())}


def phase_family_reduced(cell: str):
    """M-RoPE (qwen2-vl-72b), encoder-decoder (seamless-m4t-medium) or
    hybrid (hymba-1.5b) fleet training of the reduced config under the
    f32 policy against the monolithic step: 3 steps on batches with the
    stubbed frontends' inputs, device 2 failing in step 1's backward,
    beside a bf16-policy control; then serving: qwen2-vl through the fleet
    session (paged read checked every step) against token-by-token
    monolithic decoding, seamless on the monolithic path, prefill then
    decode against token by token, hymba on the monolithic path as
    ``launch/serve.py`` runs it, and its token-by-token decode of the
    prompt and the first new token against a forward."""
    import numpy as np
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_train_step
    dev = torch.device("cuda")
    cfg, chunks, opt_cfg, params, opt, data, sess, ctl = f32_cell(cell)
    kinds = fleet_kinds(cfg, data.cfg.seq_len // chunks["loss_chunk"])
    mono = make_train_step(cfg, opt_cfg, **chunks)
    p_f, o_f, p_m, o_m, p_c, o_c = params, opt, params, opt, params, opt
    rows, audits = [], []
    for step in range(3):
        batch = family_batch(cfg, data, step, dev, grid=(2, 4))
        fail = dict(fail_ids=[2] if step == 1 else (),
                    fail_at_gemm=kinds["fwd"] - 6 * cfg.n_enc_layers + 2)
        p_m, o_m, met_m = mono(p_m, o_m, batch)
        n_fa = fa.launches
        with band_gemm_audit(verify=True) as audit:
            mark = residual_mark()
            p_f, o_f, met_f = sess.step(p_f, o_f, batch, **fail)
            res = residual_since(mark, cell, met_f["fleet"])
        audits.append(audit)
        n_fa = fa.launches - n_fa
        p_c, o_c, _ = ctl.step(p_c, o_c, batch, **fail)
        rep = met_f["fleet"]
        lm, lf = float(met_m["loss"]), float(met_f["loss"])
        gm, gf = float(met_m["grad_norm"]), float(met_f["grad_norm"])
        rows.append({"step": step, "loss_fleet": lf, "loss_mono": lm,
                     "loss_rel": abs(lf - lm) / abs(lm),
                     "grad_norm_rel": abs(gf - gm) / abs(gm),
                     "n_gemms": rep.n_gemms,
                     "gemms_by_kind": dict(collections.Counter(
                         r.kind for r in rep.records)),
                     "verified": rep.verified,
                     "n_recovered": rep.n_recovered,
                     "failed_ids": list(rep.failed_ids),
                     **res,
                     "band_gemm_checked": audit["checked"],
                     "band_gemm_max_rel_err": audit["max_rel_err"],
                     "flash_launches": n_fa})
    worst = {"params": _worst_rel(p_m, p_f), "mu": _worst_rel(o_m.mu, o_f.mu),
             "nu": _worst_rel(o_m.nu, o_f.nu),
             "params_l2": _worst_rel(p_m, p_f, norm=2),
             "control_bf16_params_l2": _worst_rel(p_m, p_c, norm=2)}
    out = {"bodies": check_bodies(cell, *audits),
           "band_gemm_step": time_band_gemm_set(audits[0]["shapes"])}

    rng = np.random.default_rng(1)
    if cfg.enc_dec:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                               device=dev)
        feats = torch.as_tensor(rng.standard_normal((2, 16, cfg.d_model))
                                .astype(np.float32), device=dev)
        n_fd = dec.flash_decode_launches
        got, first = encdec_serve(cfg, p_f, toks, feats, 4)
        n_fd = dec.flash_decode_launches - n_fd
        serve = {**_encdec_compare(cfg, got, first, encdec_references(
                     cfg, p_f, toks, feats, got[:, :1], 4, dev)),
                 "flash_decode_launches": n_fd}
        # 3 decode steps, each layer's self- and cross-attention
        serve_ok = (serve["tokens_match_token_by_token"]
                    and n_fd == 3 * 2 * cfg.n_layers
                    and serve["rel_l2"] <= 1e-4)
    elif cfg.hybrid_parallel:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                               device=dev)
        n_fd = dec.flash_decode_launches
        got, last, zero = hybrid_serve(cfg, p_f, toks, 4)
        n_fd = dec.flash_decode_launches - n_fd
        serve = {**hybrid_token_by_token(
                     cfg, p_f, torch.cat([toks, got[:, :1]], 1), dev),
                 "ssm_state_zero_after_prefill": zero,
                 "finite": bool(torch.isfinite(last).all()),
                 "flash_decode_launches": n_fd}
        # 3 decode steps, one B5 launch a layer over [meta; cache]
        serve_ok = (zero and serve["finite"] and serve["argmax_equal"]
                    and n_fd == 3 * cfg.n_layers
                    and serve["rel_l2"] <= 1e-4)
    else:
        rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                                device=dev)
        ss = rt.serve_session(p_f, slots=3, page_size=4, max_len=16,
                              backend="torch", dtype_policy="f32",
                              check_paged_read=True)
        prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
                   for _ in range(3)]
        for p in prompts:
            ss.submit(p, max_new=4)
        n_b3 = dec.launches
        srep = ss.run(fail_ids=[2], fail_at_step=1)
        n_b3 = dec.launches - n_b3
        got = {r.rid: r.tokens for r in ss.batcher.finished}
        want = {i: _monolithic_greedy(cfg, p_f, p, 4, 16, dev)
                for i, p in enumerate(prompts)}
        serve = {"tokens_match": got == want,
                 "verified": all(s.verified for s in ss.step_reports),
                 "recovered": srep.n_recovered, "steps": srep.n_steps,
                 "paged_read_checks": ss.paged_read_checks,
                 "paged_decode_launches": n_b3}
        serve_ok = (got == want and serve["verified"]
                    and srep.n_recovered > 0
                    and ss.paged_read_checks == srep.n_steps == n_b3)
    emit({"phase": cell, "steps": rows, "worst_rel": worst, **out,
          "gemms_by_kind_expected": kinds,
          "params_l2_limit": TRAIN_PARAMS_L2_LIMIT, "serving": serve})
    for r in rows:
        check(r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4,
              f"{cell} step {r['step']}: loss/grad_norm off {r}")
        check(r["verified"] and r["gemms_by_kind"] == kinds,
              f"{cell} step {r['step']}: unverified or GEMMs {r}")
        check(r["band_gemm_checked"] > 0
              and r["flash_launches"] == flash_per_step(cfg),
              f"{cell} step {r['step']}: a kernel was not launched {r}")
    check(max(worst["mu"], worst["nu"]) <= 1e-4,
          f"{cell}: moments off {worst}")
    check(worst["params_l2"] <= TRAIN_PARAMS_L2_LIMIT,
          f"{cell}: params off {worst}")
    check(worst["control_bf16_params_l2"] > TRAIN_PARAMS_L2_LIMIT,
          f"{cell}: the bf16 control passed the params check {worst}")
    check(rows[1]["n_recovered"] > 0 and rows[1]["failed_ids"] == [2],
          f"{cell}: the failure recovered nothing")
    check(serve_ok, f"{cell}: serving {serve}")
    return out


def first_decode_dense(cfg, params, prompts, cache_len, first_logits):
    """A serving session's first decode step against the monolithic path
    on the same inputs (a K/V family): per-request prefill of prompt[:-1]
    into an f32 cache (the pools' dtype), then one ``decode_step`` of the
    prompts' last tokens; relative L2 of the logits and whether the
    argmax agrees."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    slots, P = len(prompts), len(prompts[0])
    Lc, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cache = {nm: torch.zeros((Lc, slots, cache_len, K, hd), device=dev)
             for nm in ("k", "v")}
    with torch.no_grad():
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
    return {"rel_l2": float(diff.norm()
                            / ref_logits[..., :V].float().norm()),
            "argmax_equal": bool((first_logits[..., :V].argmax(-1)
                                  == ref_logits[..., :V].argmax(-1)).all())}


# hymba_full's predicted peak (PERF.md, Findings): bf16 params
# and grads with f32 moments (12 bytes a param), ~0.23 GB of saved
# activations a layer, the LM head's f32 products and one scan chunk's
# recompute in the backward
PREDICTED_PEAK_GB = {"hymba_full": 30.0}


def phase_family_full(cfg):
    """qwen2-vl-72b (3 layers), seamless-m4t-medium or hymba-1.5b (full
    depth) at full width, bf16: the first step's monolithic loss and
    grad_norm, then 3 fleet training steps on batches of 8 x 128 with the
    stubbed frontends' inputs (32 patches a row on a 4 x 8 M-RoPE grid,
    or 256 encoder frames a row), device 3 failing in step 1's backward,
    the params and moments updated in place for qwen2-vl and hymba; the
    first step's band GEMM launch set held against the plain version on
    fresh operands and timed; then serving: qwen2-vl through the fleet
    session (4 slots, prompts of 16, 8 new tokens, pages of 16, the paged
    read checked every step, device 3 failing at step 2), seamless on the
    monolithic path (4 prompts of 16 over 32 encoder frames, 8 greedy
    tokens, the first decode step against a forward over the prompt and
    the first new token), hymba on the monolithic path as
    ``launch/serve.py`` runs it (4 prompts of 16, 8 greedy tokens; its
    token-by-token decode of the prompt and the first new token against a
    forward)."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cell = ("encdec_full" if cfg.enc_dec else
            "hymba_full" if cfg.hybrid_parallel else "mrope_full")
    # the earlier phases' runtimes hold padded operand copies in reference
    # cycles: collect them, so the peak below is this cell's alone
    gc.collect()
    torch.cuda.empty_cache()
    donate = not cfg.enc_dec
    B, S, n_steps = 8, 128, 3
    chunks = dict(q_chunk=64, k_chunk=64, loss_chunk=64)
    kinds = fleet_kinds(cfg, S // chunks["loss_chunk"])
    # the forward's GEMMs come first (the encoder's recompute runs in the
    # backward): the failure strikes at the backward's fourth
    fail_at = kinds["fwd"] - 6 * cfg.n_enc_layers + 3
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=3, total_steps=n_steps)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in T.leaves(params))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    batches = [family_batch(cfg, data, step, dev, grid=(4, 8))
               for step in range(n_steps)]
    # the monolithic path first, before the moments exist
    t0 = time.perf_counter()
    (loss_m, _), grads = M.value_and_grad(cfg, params, batches[0], **chunks)
    gnorm_m = float(adam.global_norm(grads, sliced=True))
    del grads
    torch.cuda.synchronize()
    t_mono = time.perf_counter() - t0
    opt = adam.init(params, opt_cfg)
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    sess = rt.train_session(opt_cfg, backend="torch", dtype_policy="bf16",
                            **chunks)
    rows, audits = [], []
    bg.launches = fa.launches = 0
    reset_body_counts()
    torch.cuda.reset_peak_memory_stats()
    for step, batch in enumerate(batches):
        n_b1, n_fa = bg.launches, fa.launches
        with band_gemm_audit(verify=False) as audit:
            mark = residual_mark()
            params, opt, met = sess.step(
                params, opt, batch, fail_ids=[3] if step == 1 else (),
                fail_at_gemm=fail_at, donate=donate)
            res = residual_since(mark, cell, met["fleet"])
        audits.append(audit)
        rep = met["fleet"]
        rows.append({
            "step": step, "loss": rep.loss, "grad_norm": rep.grad_norm,
            "wall_s": rep.wall_time, "fleet_exec_s": rep.fleet_exec_time,
            "n_gemms": rep.n_gemms, "gemms_by_kind": dict(
                collections.Counter(r.kind for r in rep.records)),
            "n_tasks": rep.n_tasks, "n_recovered": rep.n_recovered,
            "failed_ids": list(rep.failed_ids), "verified": rep.verified,
            "band_gemm_launches": bg.launches - n_b1,
            "flash_launches": fa.launches - n_fa, **res})
        emit({"phase": f"{cell}_step", **rows[-1]})
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train = {"band_gemm": bg.launches, "flash_attention": fa.launches,
             "bodies": check_bf16_body(f"{cell} training", *audits)}
    loss_rel = abs(rows[0]["loss"] - float(loss_m)) / abs(float(loss_m))
    gnorm_rel = abs(rows[0]["grad_norm"] - gnorm_m) / abs(gnorm_m)
    # a step's device time and the device's idle share: one more step
    # (no failure, after the launch counts above are read), its kernels
    # timed by the profiler
    step_wall, step_device_s = profiled_step(
        lambda: sess.step(params, opt, batches[0], donate=donate))
    del opt, met, batches
    torch.cuda.empty_cache()
    shapes = audits[0]["shapes"]
    gset = {**time_band_gemm_set(shapes), **check_gemm_set(shapes)}
    emit({"phase": f"{cell}_set", **gset})

    slots, P, n_gen = 4, 16, 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, P).astype(np.int32)
               for _ in range(slots)]
    bg.launches = fa.launches = 0
    dec.launches = dec.paged_element_launches = 0
    dec.flash_decode_launches = dec.flash_decode_element_launches = 0
    reset_body_counts()

    def serve_launches():
        return {"band_gemm": bg.launches, "flash_attention": fa.launches,
                "paged_decode": dec.launches,
                "flash_decode": dec.flash_decode_launches,
                "flash_decode_element": dec.flash_decode_element_launches}

    t0 = time.perf_counter()
    if cfg.enc_dec:
        toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                               device=dev)
        feats = torch.as_tensor(rng.standard_normal(
            (slots, 2 * P, cfg.d_model)).astype(np.float32), device=dev)
        with band_gemm_audit(verify=False) as saudit:
            got, first = encdec_serve(cfg, params, toks, feats, n_gen)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        serving = serve_launches()
        cmp = _encdec_compare(cfg, got, first, encdec_references(
            cfg, params, toks, feats, got[:, :1], n_gen, dev))
        serve = {"n_tokens": slots * n_gen, "tokens_per_s":
                 slots * n_gen / t_serve}
    elif cfg.hybrid_parallel:
        toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                               device=dev)
        with band_gemm_audit(verify=False) as saudit:
            got, last, zero = hybrid_serve(cfg, params, toks, n_gen)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        serving = serve_launches()
        toks17 = torch.cat([toks, got[:, :1]], 1)
        cmp = hybrid_token_by_token(cfg, params, toks17, dev)
        # the same comparison on an f32 copy of the params, at full width
        # and depth: where the bf16 one reads rounding, this one reads
        # the code
        cmp["float32"] = hybrid_token_by_token(
            dataclasses.replace(cfg, dtype="float32", param_dtype="float32"),
            T.map_tree(lambda t: t.float(), params), toks17, dev)
        serve = {"n_tokens": slots * n_gen,
                 "tokens_per_s": slots * n_gen / t_serve,
                 "ssm_state_zero_after_prefill": zero,
                 "finite": bool(torch.isfinite(last).all())}
    else:
        rt2 = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                                 device=dev)
        ss = rt2.serve_session(params, slots=slots, page_size=16,
                               max_len=P + n_gen, backend="torch",
                               dtype_policy="bf16", check_paged_read=True)
        for p in prompts:
            ss.submit(p, max_new=n_gen)
        with band_gemm_audit(verify=False) as saudit:
            first = ss.step()
            first_logits = ss.last_logits.clone()
            srep = ss.run(fail_ids=[3], fail_at_step=1)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        serving = serve_launches()
        cmp = first_decode_dense(cfg, params, prompts, ss.cache_len,
                                 first_logits)
        serve = {"n_tokens": srep.n_tokens, "n_steps": srep.n_steps,
                 "tokens_per_s": srep.tokens_per_sec,
                 "gemms_per_decode_step": len(first.records),
                 "all_verified": all(s.verified for s in ss.step_reports),
                 "failed_ids": list(srep.failed_ids),
                 "recovered": srep.n_recovered,
                 "paged_read_checks": ss.paged_read_checks}
    if saudit["shapes"]:
        serving["bodies"] = check_bf16_body(f"{cell} serving", saudit)
    row = {"phase": cell, "arch": cfg.name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "n_params": n_params,
           "batch": B, "seq": S, "param_init_s": t_init,
           "mono_grad_s": t_mono, "loss_mono": float(loss_m),
           "grad_norm_mono": gnorm_m, "first_step_loss_rel": loss_rel,
           "first_step_grad_norm_rel": gnorm_rel,
           "max_memory_allocated_gb": peak_gb,
           "max_memory_predicted_gb": PREDICTED_PEAK_GB.get(cell),
           "state_gb": 12 * n_params / 1e9, "donate": donate,
           "step_wall_s": step_wall, "step_device_s": step_device_s,
           "step_device_idle_share": max(0.0, 1 - step_device_s / step_wall),
           "launches_training": train, "launches_serving": serving,
           "serve_s": t_serve, **{f"serve_{k}": v for k, v in serve.items()},
           "first_decode": cmp, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    for r in rows:
        check(r["verified"] and r["gemms_by_kind"] == kinds,
              f"{cell} step {r['step']}: unverified or GEMMs {r} "
              f"(expected {kinds})")
        check(r["band_gemm_launches"] > 0
              and r["flash_launches"] == flash_per_step(cfg),
              f"{cell} step {r['step']}: kernel launches {r}")
        check(bool(np.isfinite(r["loss"])),
              f"{cell} step {r['step']}: loss {r['loss']}")
    check(rows[1]["failed_ids"] == [3] and rows[1]["n_recovered"] > 0,
          f"{cell}: the failure did not fire or recovered nothing")
    check(peak_gb < 80.0, f"{cell}: peak memory {peak_gb} GB")
    # every GEMM output is rounded to bf16, in another order on each path
    check(loss_rel <= 1e-2, f"{cell}: first-step loss rel {loss_rel}")
    check(gnorm_rel <= 5e-2, f"{cell}: first-step grad_norm rel {gnorm_rel}")
    # bf16 roundings grow with depth: at 32 layers the reference's own
    # decode of hymba's prompt is 5.5e-2 off its forward (d 256, bf16,
    # the CPU; llama3-8b's 1.9e-2), so the hybrid's bf16 bound is 1e-1
    # and its f32 copy is held to 1e-4 (the reference's CPU gap at 32
    # layers in f32: 5.5e-6)
    check(cmp["rel_l2"] <= (1e-1 if cfg.hybrid_parallel else 2e-2),
          f"{cell}: first decode step's logits {cmp}")
    check(not cfg.hybrid_parallel or cmp["float32"]["rel_l2"] <= 1e-4,
          f"{cell}: f32 decode against the forward {cmp}")
    check(step_device_s > 0, f"{cell}: the profiler saw no device time")
    if cfg.enc_dec:
        # the cross cache (the encoder, one flash launch a layer) and the
        # prefill (the encoder again, each decoder layer's self- and
        # cross-attention), then 7 decode steps of self- and
        # cross-attention on the flash-decode kernel; no fleet GEMM
        check(serving["flash_attention"]
              == 2 * cfg.n_enc_layers + 2 * cfg.n_layers
              and serving["paged_decode"] == 0
              and serving["flash_decode"] == 2 * cfg.n_layers * (n_gen - 1)
              and serving["flash_decode_element"] == 0,
              f"{cell}: serving launches {serving}")
    elif cfg.hybrid_parallel:
        # one prefill (a flash launch a layer, over [meta; prompt]), then
        # 7 decode steps, each layer's attention on the flash-decode
        # kernel over [meta; cache]; no fleet GEMM
        check(serve["ssm_state_zero_after_prefill"] and serve["finite"],
              f"{cell}: serving {serve}")
        check(serving["flash_attention"] == cfg.n_layers
              and serving["paged_decode"] == 0
              and serving["band_gemm"] == 0
              and serving["flash_decode"] == cfg.n_layers * (n_gen - 1)
              and serving["flash_decode_element"] == 0,
              f"{cell}: serving launches {serving}")
    else:
        check(serve["all_verified"] and serve["failed_ids"] == [3]
              and serve["recovered"] > 0,
              f"{cell}: serving unverified or unrecovered {serve}")
        check(serve["paged_read_checks"] == serve["n_steps"]
              == serving["paged_decode"]
              and serving["flash_attention"] == slots * cfg.n_layers
              and serving["flash_decode"] == serve["n_steps"] * cfg.n_layers
              and serving["band_gemm"] > 0,
              f"{cell}: serving launches {serving}")
    return {"training": train, "serving": serving, "set": gset,
            "max_abs_err": gset["max_abs_err"]}


# -------------------------------------------------- multi-PS and batch ----

# multips_full's peak device memory, GB, as predicted before its first run
# (PERF.md §6): two islands' bf16 params and f32 moments with the f32
# anchor and velocity, 53.8 GB, plus one island's step
MULTIPS_PEAK_PREDICTED_GB = (58.0, 72.0)


def _bits(t):
    """A tensor's raw bits where its type is bfloat16, else the tensor."""
    import torch
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def tree_bit_equal(a, b) -> bool:
    """Two trees (nested dicts, tuples such as ``AdamState``) equal leaf for
    leaf in type and bits."""
    import torch
    from repro_torch.checkpointing.checkpoint import _flatten
    la, lb = _flatten(a), _flatten(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype
        and torch.equal(_bits(la[k]), _bits(lb[k])) for k in la)


def island_shards(cfg, B, S, step, dev, seeds=(0, 7)):
    """One training batch for each island, from its own data seed."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return [{k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(DataConfig(
                 vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                 seed=s)).batch(step).items()} for s in seeds]


@contextlib.contextmanager
def outer_round_probe(check_monolithic: bool):
    """Wraps ``diloco.outer_step_sharded`` while a session runs: records
    each round's device time by CUDA events and, with
    ``check_monolithic``, whether the round's params and outer state equal
    the monolithic ``outer_step``'s on the same inputs bit for bit (the
    monolithic round runs first, and does not write its inputs)."""
    import torch
    from repro_torch.optim import diloco
    real = diloco.outer_step_sharded
    probe = {"ms": [], "bit_equal_monolithic": []}

    def probed(state, groups, part, cfg, donate=False):
        mono = diloco.outer_step(state, groups, cfg) \
            if check_monolithic else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(state, groups, part, cfg, donate=donate)
        end.record()
        end.synchronize()
        probe["ms"].append(start.elapsed_time(end))
        if mono is not None:
            probe["bit_equal_monolithic"].append(
                tree_bit_equal(mono[0], out[0])
                and tree_bit_equal(mono[1], out[1]))
        return out

    diloco.outer_step_sharded = probed
    try:
        yield probe
    finally:
        diloco.outer_step_sharded = real


def phase_multips_reduced():
    """Multi-PS training of ``llama3-8b.reduced()`` under the f32 policy
    (``Fleet.sample(8, seed=0)``, B 2 x S 32, chunks of 16): K=1/H=1
    against the single-PS session; K=2/H=2 on two data shards (drift after
    step 1, equal replicas after the round, the sync volume, the sharded
    round against the monolithic one); donated islands against copying
    ones; a checkpoint at the round boundary restored and resumed, and a
    bf16 copy of the state round-tripped; a PS failure mid-round; a
    device failure inside island 1."""
    import tempfile
    import torch
    from repro_torch import tree as T
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adam, diloco
    from repro_torch.train_loop.multi_ps import _own
    dev = torch.device("cuda")
    cfg = get_config("llama3-8b").reduced()
    chunks = dict(q_chunk=16, k_chunk=16, loss_chunk=16)
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=2, total_steps=20)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adam.init(params, opt_cfg)
    ckdir = tempfile.mkdtemp(prefix="multips_reduced_")

    def shards(step):
        return island_shards(cfg, 2, 32, step, dev)

    def session(n_ps, h=2, checkpoint=None):
        rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                                device=dev)
        return rt.train_session(
            opt_cfg, backend="torch", dtype_policy="f32", n_ps=n_ps,
            diloco=None if h is None else diloco.DiLoCoConfig(
                inner_steps=h, outer_lr=0.7),
            checkpoint=checkpoint, checkpoint_every=2, **chunks)

    # (a) K=1/H=1 against the single-PS session, 2 steps
    single, k1 = session(1, h=None), session(1, h=1)
    p, o = _own(params), _own(opt)
    st = k1.init(_own(params), _own(opt))
    k1_loss_equal = []
    for step in range(2):
        batch = shards(step)[0]
        p, o, met_s = single.step(p, o, batch)
        st, met_m = k1.step(st, batch)
        k1_loss_equal.append(float(met_s["loss"]) == met_m["loss"])
    k1_bits = {"params": tree_bit_equal(p, st.params),
               "mu": tree_bit_equal(o.mu, st.opt_state.mu),
               "nu": tree_bit_equal(o.nu, st.opt_state.nu)}

    # (b) K=2/H=2, copying, its first step's launches held against the
    # plain version; (c) the same run with every update in place
    copying = session(2, checkpoint=ckdir)
    with outer_round_probe(check_monolithic=True) as probe:
        st_c = copying.init(_own(params), _own(opt))
        bg.launches = fa.launches = 0
        mark = residual_mark()
        with band_gemm_audit(verify=True) as audit:
            st_c, m1 = copying.step(st_c, shards(0))
        first_res = residual_since(mark, "multips_reduced",
                                   m1["multi_ps"].island_reports)
        drift = not tree_bit_equal(st_c.island_params[0],
                                   st_c.island_params[1])
        st_c, m2 = copying.step(st_c, shards(1))
        launches = {"band_gemm": bg.launches,
                    "flash_attention": fa.launches,
                    "first_step": first_res}
        donated = session(2)
        st_d = donated.init(_own(params), _own(opt))
        for step in range(2):
            st_d, _ = donated.step(st_d, shards(step), donate=True)
    part = diloco.partition_params(st_c.params, 2)
    rep1, rep2 = m1["multi_ps"], m2["multi_ps"]
    donated_equal = (all(tree_bit_equal(a, b) for a, b in zip(
        st_c.island_params + st_c.island_opt,
        st_d.island_params + st_d.island_opt))
        and tree_bit_equal(st_c.outer, st_d.outer))

    # (d) the round-boundary checkpoint into a fresh session, one resumed
    # step; a bf16 copy of the state through save and restore
    fresh = session(2, checkpoint=ckdir)
    st_r, step_r = fresh.restore(fresh.init(_own(params), _own(opt)))
    restored_equal = (all(tree_bit_equal(a, b) for a, b in zip(
        st_c.island_params + st_c.island_opt,
        st_r.island_params + st_r.island_opt))
        and tree_bit_equal(st_c.outer, st_r.outer))
    st_c3, m3 = copying.step(st_c, shards(2))
    st_r3, m3r = fresh.step(st_r, shards(2))
    resumed_equal = (m3["loss"] == m3r["loss"]
                     and tree_bit_equal(st_c3.params, st_r3.params))
    bf16 = {"params": T.map_tree(lambda x: x.to(torch.bfloat16),
                                 st_c3.params),
            "outer": st_c3.outer, "opt": st_c3.opt_state}
    path = os.path.join(ckdir, "bf16_copy.npz")
    ckpt.save(path, bf16)
    bf16_back = ckpt.restore(path, {
        "params": T.map_tree(torch.zeros_like, bf16["params"]),
        "outer": diloco.OuterState(*(T.map_tree(torch.zeros_like, t)
                                     for t in bf16["outer"])),
        "opt": adam.AdamState(torch.zeros((), dtype=torch.int32),
                              *(T.map_tree(torch.zeros_like, t)
                                for t in bf16["opt"][1:]))})
    bf16_equal = tree_bit_equal(bf16, bf16_back) and all(
        a.device == b.device for a, b in zip(T.leaves(bf16["params"]),
                                             T.leaves(bf16_back["params"])))

    # (e) PS 1 fails mid-round; (f) a device fails inside island 1
    churn = session(2)
    ids = sorted(churn.rt.fleet.ids())
    st_e = churn.init(_own(params), _own(opt))
    st_e, _ = churn.step(st_e, shards(0))
    st_e, m_e = churn.step(st_e, shards(1), fail_ps=1)
    st_e, m_e2 = churn.step(st_e, shards(2)[0])
    rep_e = m_e["multi_ps"]
    inside = session(2)
    victim = sorted(inside.sharded[1].fleet.ids())[0]
    st_f = inside.init(_own(params), _own(opt))
    st_f, m_f = inside.step(st_f, shards(0), fail_ids=[victim],
                            fail_island=1, fail_at_gemm=20)
    rep_f = m_f["islands"][1]

    out = {"launches": launches,
           "bodies": check_bodies("multips_reduced", audit)}
    emit({"phase": "multips_reduced",
          "k1_h1": {"loss_equal": k1_loss_equal, **k1_bits},
          "k2_h2": {"island_sizes": [len(g) for g in copying.sharded],
                    "losses": [list(rep1.island_loss),
                               list(rep2.island_loss)],
                    "drift_after_step_1": drift,
                    "synced": [rep1.synced, rep2.synced],
                    "replicas_equal_after_round": tree_bit_equal(
                        st_c.island_params[0], st_c.island_params[1]),
                    "cross_ps_sync_bytes": rep2.cross_ps_sync_bytes,
                    "shard_bytes": list(part.shard_bytes),
                    "predicted_sync_time_s": rep2.predicted_sync_time,
                    "outer_round_ms": probe["ms"],
                    "sharded_round_bit_equal_monolithic":
                        probe["bit_equal_monolithic"],
                    "band_gemm_checked": audit["checked"],
                    "band_gemm_max_rel_err": audit["max_rel_err"],
                    "verified": all(r.verified for r in
                                    rep1.island_reports
                                    + rep2.island_reports)},
          "donated_bit_equal_copying": donated_equal,
          "checkpoint": {"steps": copying.checkpoint.steps(),
                         "restored_step": step_r, "round": st_r.round,
                         "restored_bit_equal": restored_equal,
                         "resumed_step_bit_equal": resumed_equal,
                         "bf16_copy_bit_equal": bf16_equal},
          "fail_ps": {"evicted_ps": rep_e.evicted_ps,
                      "n_devices_reassigned": rep_e.n_devices_reassigned,
                      "survivor_ids": sorted(
                          churn.islands[0].rt.fleet.ids()),
                      "survivor_loss": m_e2["loss"],
                      "verified": m_e2["islands"][0].verified},
          "device_failure": {"victim": victim,
                             "n_recovered": rep_f.n_recovered,
                             "verified": rep_f.verified},
          **out})
    check(all(k1_loss_equal) and all(k1_bits.values()),
          f"multips_reduced: K=1/H=1 differs from the single-PS session "
          f"{k1_loss_equal} {k1_bits}")
    check([len(g) for g in copying.sharded] == [4, 4],
          "multips_reduced: islands are not 4 + 4")
    check(drift and not rep1.synced and rep2.synced and rep2.round == 1,
          "multips_reduced: no drift before the round, or no round")
    check(tree_bit_equal(st_c.island_params[0], st_c.island_params[1]),
          "multips_reduced: replicas differ after the round")
    check(rep2.cross_ps_sync_bytes == 2 * sum(part.shard_bytes),
          f"multips_reduced: sync bytes {rep2.cross_ps_sync_bytes}")
    check(probe["bit_equal_monolithic"] == [True, True],
          f"multips_reduced: sharded round vs monolithic "
          f"{probe['bit_equal_monolithic']}")
    check(all(r.verified for r in rep1.island_reports
              + rep2.island_reports), "multips_reduced: a step unverified")
    check(audit["checked"] > 0 and launches["band_gemm"] > 0
          and launches["flash_attention"] > 0,
          f"multips_reduced: a kernel was not launched {launches}")
    check(donated_equal, "multips_reduced: in-place islands differ from "
          "copying ones")
    check(step_r == 2 and st_r.round == 1 and restored_equal
          and resumed_equal and bf16_equal,
          "multips_reduced: the checkpoint did not restore bit for bit")
    check(rep_e.evicted_ps == 1 and rep_e.n_devices_reassigned == 4
          and churn.n_islands == 1
          and sorted(churn.islands[0].rt.fleet.ids()) == ids
          and m_e2["islands"][0].verified
          and bool(torch.isfinite(torch.tensor(m_e2["loss"]))),
          "multips_reduced: the PS failure was not absorbed")
    check(rep_f.n_recovered > 0 and rep_f.verified
          and victim not in inside.islands[1].rt.fleet.ids(),
          "multips_reduced: the device failure in island 1 recovered "
          "nothing")
    return out


def phase_multips_full(cfg):
    """llama3-8b at full width, 4 layers, bf16, ``Fleet.sample(16,
    seed=0)`` split into 2 islands of 8: K=2, H=2, batch 8 x 128 an
    island from two data seeds, params, moments and the outer round
    updated in place.  Step 1: a device failure in island 1's backward;
    step 2 ends round 1; step 3: PS 1 fails; step 4: the survivor over all
    16 devices.  Island 0's first step against the monolithic path and
    its band GEMM set against the plain version; the peak memory beside
    the prediction."""
    import torch
    from repro_torch import tree as T
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adam, diloco
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    B, S, n_steps = 8, 128, 4
    chunks = dict(q_chunk=64, k_chunk=64, loss_chunk=64)
    opt_cfg = adam.AdamConfig(lr=3e-4, warmup_steps=3, total_steps=n_steps)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in T.leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in T.leaves(params))
    batches = [island_shards(cfg, B, S, step, dev) for step in range(n_steps)]
    # island 0's first step on the monolithic path, before the moments
    (loss_m, _), grads = M.value_and_grad(cfg, params, batches[0][0],
                                          **chunks)
    gnorm_m = float(adam.global_norm(grads, sliced=True))
    del grads
    opt = adam.init(params, opt_cfg)
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    sess = rt.train_session(opt_cfg, backend="torch", dtype_policy="bf16",
                            n_ps=2, diloco=diloco.DiLoCoConfig(
                                inner_steps=2, outer_lr=0.7), **chunks)
    sizes = [len(g) for g in sess.sharded]
    st = sess.init(params, opt)
    del params, opt
    victim = sorted(sess.sharded[1].fleet.ids())[1]
    plan = [dict(fail_ids=[victim], fail_island=1, fail_at_gemm=45), {},
            dict(fail_ps=1), {}]
    isl0 = sess.islands[0].session
    marks = []

    def island0_step(*a, **kw):            # brackets island 0's launches
        marks.append(len(audit["shapes"]))
        out = type(isl0).step(isl0, *a, **kw)
        marks.append(len(audit["shapes"]))
        return out

    rows, audits = [], []
    bg.launches = fa.launches = 0
    reset_body_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with outer_round_probe(check_monolithic=False) as probe:
        for step, kw in enumerate(plan):
            n_b1, n_fa = bg.launches, fa.launches
            mark = residual_mark()
            # one batch an island alive at the step's start
            batch = batches[step][:sess.n_islands]
            with band_gemm_audit(verify=False) as audit:
                if step == 0:
                    isl0.step = island0_step
                try:
                    st, met = sess.step(st, batch, donate=True, **kw)
                finally:
                    isl0.__dict__.pop("step", None)
            audits.append(audit)
            rep = met["multi_ps"]
            res = residual_since(mark, "multips_full", rep.island_reports)
            torch.cuda.synchronize()
            rows.append({
                "step": step + 1, "round": rep.round, "synced": rep.synced,
                "n_islands": rep.n_islands, "loss": rep.loss,
                "island_loss": list(rep.island_loss),
                "island_grad_norm": [r.grad_norm
                                     for r in rep.island_reports],
                "island_wall_s": [r.wall_time for r in rep.island_reports],
                "island_fleet_exec_s": [r.fleet_exec_time
                                        for r in rep.island_reports],
                "wall_s": rep.wall_time,
                "island_devices": [len(i.rt.fleet) for i in sess.islands],
                "n_recovered": [r.n_recovered for r in rep.island_reports],
                "failed_ids": [list(r.failed_ids)
                               for r in rep.island_reports],
                "verified": all(r.verified and all(x.verified
                                                   for x in r.records)
                                for r in rep.island_reports),
                "evicted_ps": rep.evicted_ps,
                "n_devices_reassigned": rep.n_devices_reassigned,
                "cross_ps_sync_bytes": rep.cross_ps_sync_bytes,
                "predicted_sync_time_s": rep.predicted_sync_time,
                "predicted_makespan_s": rep.predicted_makespan,
                "replicas_bit_equal": (tree_bit_equal(
                    st.island_params[0], st.island_params[1])
                    if st.n_islands > 1 else None),
                "band_gemm_launches": bg.launches - n_b1,
                "flash_launches": fa.launches - n_fa, **res,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9})
            emit({"phase": "multips_full_step", **rows[-1]})
    launches = {"band_gemm": bg.launches, "flash_attention": fa.launches,
                "band_gemm_bodies": check_bf16_body("multips_full",
                                                    *audits)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = rows[0]
    loss_rel = abs(first["island_loss"][0] - float(loss_m)) \
        / abs(float(loss_m))
    gnorm_rel = abs(first["island_grad_norm"][0] - gnorm_m) / abs(gnorm_m)
    # the round reads both replicas and the f32 anchor and velocity, and
    # writes them all back
    outer_bytes = 4 * param_bytes + 4 * 4 * n_params
    del st, met, batches
    gc.collect()
    torch.cuda.empty_cache()
    isl0_shapes = audits[0]["shapes"][marks[0]:marks[1]]
    gemm_check = check_gemm_set(isl0_shapes)
    row = {"phase": "multips_full", "arch": cfg.name,
           "n_layers": cfg.n_layers, "n_params": n_params,
           "param_bytes": param_bytes, "island_sizes": sizes,
           "batch_per_island": [B, S], "launches": launches,
           "island0_first_step": {"loss_rel": loss_rel,
                                  "grad_norm_rel": gnorm_rel,
                                  "loss_mono": float(loss_m),
                                  "grad_norm_mono": gnorm_m,
                                  "band_gemm_launches": len(isl0_shapes),
                                  **gemm_check},
           "outer_round_ms": probe["ms"],
           "outer_round_bound_ms": outer_bytes / PEAK_BW * 1e3,
           "outer_round_bytes": outer_bytes,
           "peak_memory_gb": peak_gb,
           "peak_memory_predicted_gb": list(MULTIPS_PEAK_PREDICTED_GB),
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(sizes == [8, 8], f"multips_full: islands {sizes}")
    for r in rows:
        check(r["verified"], f"multips_full step {r['step']}: unverified")
        check(all(math.isfinite(x) for x in r["island_loss"]),
              f"multips_full step {r['step']}: loss {r['island_loss']}")
        check(r["band_gemm_launches"] > 0 and r["flash_launches"] > 0,
              f"multips_full step {r['step']}: a kernel was not launched")
    check(rows[0]["failed_ids"][1] == [victim]
          and rows[0]["n_recovered"][1] > 0,
          "multips_full: the failure in island 1 recovered nothing")
    check(rows[1]["synced"] and rows[1]["round"] == 1
          and rows[1]["replicas_bit_equal"],
          "multips_full: the round did not leave equal replicas")
    check(rows[1]["cross_ps_sync_bytes"] == 2 * param_bytes,
          f"multips_full: sync bytes {rows[1]['cross_ps_sync_bytes']}")
    check(rows[2]["evicted_ps"] == 1 and rows[2]["n_islands"] == 1
          and rows[3]["island_devices"] == [16],
          "multips_full: PS 1's devices did not join the survivor")
    check(len(probe["ms"]) == 1, f"multips_full: {len(probe['ms'])} rounds")
    check(loss_rel <= 1e-2, f"multips_full: island 0 loss rel {loss_rel}")
    check(gnorm_rel <= 5e-2,
          f"multips_full: island 0 grad_norm rel {gnorm_rel}")
    return {"training": launches, "rows": rows, "summary": row}


def f64_freivalds_margin(A, B, block, rect, task: int, seed: int,
                         rtol: float) -> float:
    """The band executor's Freivalds acceptance test on one returned
    ``block`` of C = A·B over ``rect`` = (r0, r1, c0, c1), with f64
    residuals and the probes the executor drew for task ``task`` under
    ``seed`` (``ops.rademacher``: row signs over the block's rows, column
    signs over C's columns): the largest ``|lhs - rhs|`` over its
    allowance ``rtol * (|rhs| + Σ|block|)``.  At most 1 passes."""
    from repro_torch.kernels import ops
    r0, r1, c0, c1 = rect
    dev = block.device
    rs = ops.rademacher(seed, [task], 2, r1 - r0, 0, dev)[0].double()
    ss = ops.rademacher(seed, [task], 2, c1, 1, dev)[0, :, c0:].double()
    blk = block.double()
    lhs = ((rs @ A[r0:r1].double()) * (B[:, c0:c1].double() @ ss.T).T).sum(1)
    rhs = ((rs @ blk) * ss).sum(1)
    allowed = rtol * rhs.abs() + rtol * (float(blk.abs().sum()) + 1e-30)
    return float(((lhs - rhs).abs() / allowed).max())


def poison_escapes(clean, poisoned, bad: int, inputs, policy: str = "f32"):
    """Where a poisoning walk's outputs differ from the clean walk's by
    more than 1e-5 of a GEMM's largest output.  The executors poison a
    rectangle as ``C[r0, c0] += 1 + |C[r0, c0]|``, and a Freivalds check
    passes a block whose residual lies within ``rtol * (|rhs| + Σ|C|)``
    with the policy's ``rtol``: an injection below that cannot be told
    from rounding and stays.  Counts each such difference as an escape at
    an injection site of the poisoning device, or as a difference anywhere
    else (which no check excuses).  Each escape is judged again by the
    executor's acceptance test (``torch_executor``'s ``finalize``) on f64
    residuals of the same block, operands (``inputs``) and probes (the
    step's ``verify_seed``, the task's index): ``f64_passes`` counts the
    escapes it passes too, ``worst_f64_margin`` is the largest residual
    over its allowance among them."""
    from repro_torch.core.torch_executor import POLICIES
    pol = POLICIES[policy]
    out = {"escapes": 0, "other_diffs": 0, "f64_passes": 0,
           "worst_f64_margin": 0.0}
    for a, b in zip(clean.steps, poisoned.steps):
        d = (a.output - b.output).abs()
        far = (d > 1e-5 * float(a.output.abs().max())).nonzero().tolist()
        if not far:
            continue
        # no device failed: the tasks are the plan's assignments in order
        sites = {(x.r0, x.c0): (i, x)
                 for i, x in enumerate(b.plan.assignments)
                 if x.device_id == bad}
        A, B = inputs(b.gemm)
        for r, c in far:
            if (r, c) not in sites:
                out["other_diffs"] += 1
                continue
            out["escapes"] += 1
            i, x = sites[(r, c)]
            margin = f64_freivalds_margin(
                A, B, b.output[x.r0:x.r1, x.c0:x.c1],
                (x.r0, x.r1, x.c0, x.c1), i, b.verify_seed,
                pol.freivalds_rtol(b.gemm.n, (x.r1 - x.r0) * (x.c1 - x.c0)))
            out["f64_passes"] += int(margin <= 1.0)
            out["worst_f64_margin"] = max(out["worst_f64_margin"], margin)
    return out


def phase_batch(cfg):
    """``execute_batch(8, 128)`` of llama3-8b (4 layers, full width) on
    ``Fleet.sample(16, seed=0)``, torch backend under the f32 policy, the
    whole DAG: level against dataflow dispatch bit for bit; the first two
    levels against the numpy backend's f64 products; a failing and a
    poisoning device against the clean run."""
    import numpy as np
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.api.runtime import device_operands
    from repro_torch.kernels import block_gemm as bg
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)
    # the walks' own operands (execute_batch's default on the torch
    # backend), for the f64 comparisons
    inputs = device_operands(dev, seed=0)
    ids = sorted(rt.fleet.ids())

    def walk(name, **kw):
        cache = rt._pad_cache
        h0, m0 = (cache.hits, cache.misses) if cache else (0, 0)
        bg.launches = 0
        mark = residual_mark()
        rep = rt.execute_batch(8, 128, backend="torch", dtype_policy="f32",
                               seed=0, **kw)
        torch.cuda.synchronize()
        # a dataflow walk that re-runs the dependents of a flagged GEMM
        # reports each GEMM's last run alone, so its counters are held to
        # the launches only where nothing was re-run
        res = residual_since(mark, "batch",
                             None if rep.n_redispatched else rep.steps)
        hits, misses = rt._pad_cache.hits - h0, rt._pad_cache.misses - m0
        row = {"walk": name, "dispatch": rep.dispatch,
               "wall_s": rep.wall_time, "n_gemms": len(rep.steps),
               "n_levels": rep.n_levels, "n_tasks": rep.n_tasks,
               "band_gemm_launches": bg.launches, **res,
               "verified": rep.verified, "n_recovered": rep.n_recovered,
               "n_redispatched": rep.n_redispatched,
               "predicted_gemm_time_s": rep.predicted_gemm_time,
               "predicted_overlap_time_s": rep.predicted_overlap_time,
               "pad_cache_hit_rate": hits / max(hits + misses, 1),
               "pad_cache_hits": hits, "pad_cache_misses": misses}
        return rep, row

    def compare(want, got):
        """Worst relative difference of two walks' outputs, and whether
        they are equal bit for bit."""
        worst, same = 0.0, True
        for a, b in zip(want.steps, got.steps):
            worst = max(worst, float((a.output - b.output).abs().max())
                        / max(float(a.output.abs().max()), 1e-30))
            same = same and torch.equal(a.output, b.output)
        return worst, same

    rows = []
    lv, row = walk("clean", dispatch="level")
    rows.append(row)
    df, row = walk("clean", dispatch="dataflow")
    row["max_rel_vs_level"], row["bit_equal_level"] = compare(lv, df)
    rows.append(row)
    emit({"phase": "batch_walk", **rows[0]})
    emit({"phase": "batch_walk", **rows[1]})
    launches = {"level": rows[0]["band_gemm_launches"],
                "dataflow": rows[1]["band_gemm_launches"]}
    del df
    # the first two levels against the numpy backend's f64 products
    np_rep = rt.execute_batch(8, 128, backend="numpy", inputs=inputs,
                              dispatch="level", max_levels=2)
    np_rel = max(float(np.abs(s_np.output - s.output.double().cpu()
                              .numpy()).max()
                       / max(np.abs(s_np.output).max(), 1e-30))
                 for s_np, s in zip(np_rep.steps, lv.steps))
    del np_rep
    fail, row = walk("failing", dispatch="dataflow", fail_ids=ids[:2])
    row["max_rel_vs_clean"], row["bit_equal_clean"] = compare(lv, fail)
    rows.append(row)
    emit({"phase": "batch_walk", **row})
    del fail
    poison, row = walk("poisoning", dispatch="dataflow",
                       corrupt_ids=[ids[2]])
    row["max_rel_vs_clean"], row["bit_equal_clean"] = compare(lv, poison)
    row.update(poison_escapes(lv, poison, ids[2], inputs))
    rows.append(row)
    emit({"phase": "batch_walk", **row})
    del poison, lv
    emit({"phase": "batch", "arch": cfg.name, "n_layers": cfg.n_layers,
          "batch": [8, 128], "launches": launches,
          "numpy_first_two_levels_max_rel": np_rel,
          "phase_s": time.perf_counter() - t_phase})
    clean, flow, failing, poisoning = rows
    check(clean["verified"] and flow["verified"],
          "batch: the clean walks are not verified")
    check(flow["bit_equal_level"],
          f"batch: dataflow differs from level by {flow['max_rel_vs_level']}")
    check(launches["level"] > 0 and launches["level"] == launches["dataflow"],
          f"batch: band GEMM launches {launches}")
    check(len({r["n_gemms"] for r in rows}) == 1,
          "batch: the walks ran different GEMM counts")
    check(np_rel <= 1e-5, f"batch: the first two levels {np_rel} off f64")
    check(failing["verified"] and failing["n_recovered"] > 0
          and failing["max_rel_vs_clean"] <= 1e-5,
          f"batch: the failing walk {failing}")
    # the poisoning is caught and corrected wherever the f32 policy's
    # check flags it: every remaining difference is an injection that the
    # same acceptance test, on f64 residuals with the same probes, passes
    check(not poisoning["verified"] and poisoning["other_diffs"] == 0
          and poisoning["f64_passes"] == poisoning["escapes"],
          f"batch: the poisoning walk {poisoning}")
    return {"band_gemm": launches, "rows": rows,
            "poison": {k: poisoning[k] for k in
                       ("escapes", "f64_passes", "worst_f64_margin")}}


# the benchmark cell's fleet GEMMs that the freivalds phase runs: (name,
# m, n, q); the LM head's are one of its 16 loss chunks
FREIVALDS_GEMMS = (("head_dW", 5120, 256, 102400),
                   ("wo_dW", 16384, 4096, 5120),
                   ("router_fwd", 4096, 5120, 160),
                   ("head_fwd", 256, 5120, 102400),
                   ("head_dA", 256, 102400, 5120))
# kernel against plain: each number within this share of the absolute sum
# of its terms (both sides sum the same f32 products in another order)
FREIVALDS_TOL = 1e-5


@contextlib.contextmanager
def residual_audit():
    """Wraps the fused residual kernel's entry while a path runs: each call
    is held against the plain version on a copy of its band products
    (every number within :data:`FREIVALDS_TOL` of the absolute sum of its
    terms: Σ|C| over the rectangle for rhs and the scale, Σ_k Σ_m |A| |t|
    for lhs; the poisoned band products equal); each call's operands and
    the plain residuals are kept."""
    import numpy as np
    import torch
    from repro_torch.kernels import freivalds as fv
    real = fv.residuals_cuda
    audit = {"calls": [], "worst": 0.0, "max_rel_err": 0.0}

    def audited(As, b_op, C, meta, geom):
        C_plain = C.clone()
        got = real(As, b_op, C, meta, geom)
        want = fv.residuals_plain(As, b_op, C_plain, meta, geom)
        check(torch.equal(C, C_plain), "freivalds: the kernel's poisoned "
              "band products differ from the plain version's")
        f = fv.unpack(meta.cpu().numpy(), geom)
        it, qk, pm = geom.iters, C.shape[2], As.shape[1]
        bidx = torch.as_tensor(f["bidx"].astype(np.int64), device=C.device)
        cols = torch.arange(qk, device=C.device)
        c0 = torch.as_tensor(f["c0"].astype(np.int64), device=C.device)
        c1 = torch.as_tensor(f["c1"].astype(np.int64), device=C.device)
        s = fv.signs(torch.as_tensor(f["key_s"].astype(np.int64),
                                     device=C.device), qk) \
            * ((cols >= c0[:, None]) & (cols < c1[:, None]))[:, None]
        t = torch.einsum("kq,riq->rik", b_op.double(), s.double()).abs()
        rows = torch.arange(pm, device=C.device)
        h = torch.as_tensor(f["h"].astype(np.int64), device=C.device)
        colabs = (As.double().abs()
                  * (rows[None, :, None] < h[:, None, None])).sum(1)
        terms = torch.cat([(t * colabs[bidx][:, None]).sum(2),
                           want[:, -1:].double().expand(-1, it + 1)], 1)
        ratio = float(((got - want).double().abs()
                       / (FREIVALDS_TOL * terms + 1e-30)).max())
        audit["worst"] = max(audit["worst"], ratio)
        audit["max_rel_err"] = max(audit["max_rel_err"], float(
            ((got - want).double().abs() / (terms + 1e-30)).max()))
        audit["calls"].append((As, b_op, C, meta, geom, want.cpu().numpy()))
        del t, colabs, s, C_plain
        return got

    fv.residuals_cuda = audited
    try:
        yield audit
    finally:
        fv.residuals_cuda = real


def sign_probe(As, b_op, meta, geom, seed: int, task_ids,
               at: float) -> dict:
    """Holds the signs the residual path draws to ``ops.rademacher``'s, bit
    for bit, through the residuals themselves (:func:`freivalds.residuals`:
    the kernel on CUDA operands, the plain version on CPU ones).  The
    bucket of ``meta`` (packed for ``seed`` and ``task_ids``, its
    poisoning cleared) runs on zero operands shaped as ``As`` and
    ``b_op``, and band products that are zero but for up to 23 powers of
    two a rectangle, on an L of one column and one row through the point
    at the share ``at`` of its rows and columns.  So each rhs is a sum of
    ±2^k, exact in f32 in any order, that names each sign product r[m]·s[q]
    it holds; lhs is 0 and the scale the sum of the powers."""
    import numpy as np
    import torch
    from repro_torch.kernels import freivalds as fv
    from repro_torch.kernels import ops
    host = meta.cpu().numpy().copy()
    f = fv.unpack(host, geom)
    f["corrupt"][:] = 0.0                 # a view into host
    Gb, pm, _ = As.shape
    qk, it = b_op.shape[1], geom.iters
    r = ops.rademacher(seed, task_ids, it, pm, 0, "cpu").double()
    s = ops.rademacher(seed, task_ids, it, qk, 1, "cpu").double()
    want = torch.zeros((geom.rects, 2 * it + 1), dtype=torch.float64)
    at_b, at_m, at_q, vals = [], [], [], []
    for g in range(geom.rects):
        b = int(f["bidx"][g])
        h, c0, c1 = int(f["h"][b]), int(f["c0"][g]), int(f["c1"][g])
        m0 = min(int(at * h), h - 1)
        q0 = min(c0 + int(at * (c1 - c0)), c1 - 1)
        # 12 rows and 12 columns through (m0, q0), inside the rectangle
        r_lo = min(max(m0 - 6, 0), max(h - 12, 0))
        c_lo = min(max(q0 - 6, c0), max(c1 - 12, c0))
        rows = range(r_lo, min(r_lo + 12, h))
        cols = range(c_lo, min(c_lo + 12, c1))
        pts = [(m, q0) for m in rows] + [(m0, q) for q in cols if q != q0]
        for k, (m, q) in enumerate(pts):
            want[g, it:2 * it] += r[g, :, m] * s[g, :, q] * 2.0 ** k
            want[g, -1] += 2.0 ** k
            at_b.append(b)
            at_m.append(int(m))
            at_q.append(int(q))
            vals.append(2.0 ** k)
    dev = As.device
    C = torch.zeros((Gb, pm, qk), dtype=torch.float32, device=dev)
    where = tuple(torch.as_tensor(x, device=dev) for x in (at_b, at_m, at_q))
    C[where] = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    got = fv.residuals(torch.zeros_like(As), torch.zeros_like(b_op), C,
                       fv.to_device(host, dev), geom).double().cpu()
    return {"sign_products": len(vals) * it,
            "signs_equal": torch.equal(got, want)}


def freivalds_flagged(runs, results, n: int, policy) -> set:
    """The rectangles (global task ids) that fail the executor's acceptance
    test (``torch_executor.finalize``: ``|lhs - rhs|`` within
    ``policy.freivalds_rtol(n, area)`` of ``|rhs|`` plus the scale) for
    each bucket run and its ``(rects, 2 iters + 1)`` residuals."""
    import numpy as np
    flagged = set()
    for run, res in zip(runs, results):
        it = (res.shape[1] - 1) // 2
        lhs, rhs, scale = res[:, :it], res[:, it:2 * it], res[:, -1]
        areas = run.band_hs[run.bidx].astype(np.int64) \
            * (run.c1s - run.c0s).astype(np.int64)
        rtols = np.array([policy.freivalds_rtol(n, int(a)) for a in areas])
        ok = np.all(np.abs(lhs - rhs) <= rtols[:, None] * np.abs(rhs)
                    + (rtols * (scale + 1e-30))[:, None], axis=1)
        flagged |= {int(run.idx[g]) for g in np.flatnonzero(~ok)}
    return flagged


def phase_freivalds():
    """The fused residual kernel at the benchmark cell's own buckets, held
    to its plain version, its signs to ``ops.rademacher`` (through its
    residuals, :func:`sign_probe`) and its verdicts to the executor's
    acceptance test (:func:`freivalds_flagged`); each GEMM's buckets
    timed."""
    import numpy as np
    import torch
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.core import cost_model as cm
    from repro_torch.core.executor import build_task_list
    from repro_torch.core.torch_executor import POLICIES
    from repro_torch.kernels import freivalds as fv
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rt = TorchCleaveRuntime(arch="deepseek-v2-236b", device=dev,
                            fleet=Fleet.sample(16, seed=0,
                                               phone_fraction=0.6))
    seed = 2 ** 31 - 99
    gen = torch.Generator(device=dev).manual_seed(29)
    rows, probes = [], []
    for name, m, n, q in FREIVALDS_GEMMS:
        gemm = cm.GEMM(m=m, n=n, q=q, b=2)
        plan, _ = rt._solve_gemm(gemm)
        tasks, _ = build_task_list(gemm, plan, rt.fleet.devices)
        rects = [(x.r0, x.r1, x.c0, x.c1) for x in tasks]
        corrupt = (np.arange(len(rects)) % 3 == 1).astype(np.float32)
        A = torch.randn((m, n), generator=gen, device=dev)
        B = torch.randn((n, q), generator=gen, device=dev) / n ** 0.5
        for dt, pol in (("bfloat16", "bf16"), ("float32", "f32")):
            policy = POLICIES[pol]
            n0 = fv.launches
            with residual_audit() as audit:
                runs = ops.plan_gemm_buckets(
                    A.to(getattr(torch, dt)), B.to(getattr(torch, dt)),
                    rects, compute_dtype=dt, verify_seed=seed,
                    corrupt=corrupt, device=dev)
                torch.cuda.synchronize()
            calls = fv.launches - n0
            poisoned = set(np.flatnonzero(corrupt).tolist())
            # the kernel's verdicts and the plain version's, on the same
            # launches
            flagged = freivalds_flagged(runs, [np.concatenate(
                [r.lhs, r.rhs, r.scale[:, None]], 1) for r in runs], n,
                policy)
            plain_flagged = freivalds_flagged(
                runs, [c[-1] for c in audit["calls"]], n, policy)
            # the signs of each bucket, bit for bit, at the first, the
            # middle and the last row and column of every rectangle
            for (As, b_op, _, meta, geom, _), run in zip(audit["calls"],
                                                         runs):
                for at in (0.0, 0.5, 1.0):
                    probes.append(sign_probe(As, b_op, meta, geom, seed,
                                             run.idx, at))
                    check(probes[-1]["signs_equal"], f"freivalds: {name} "
                          f"{dt}: the kernel's signs at {at} of each "
                          "rectangle differ from ops.rademacher's")
            # each bucket timed: the kernel with the host's gaps hidden,
            # the plain version by events (its copies block the host)
            ms = plain_ms = bound = 0.0
            for As, b_op, C, meta, geom, _ in audit["calls"]:
                ms += time_ms(lambda: fv.residuals_cuda(As, b_op, C, meta,
                                                        geom),
                              iters=5, reps=3, hide_host=True)
                plain_ms += time_ms(lambda: fv.residuals_plain(
                    As, b_op, C, meta, geom), iters=2, reps=3)
                f = fv.unpack(meta.cpu().numpy(), geom)
                esz = As.element_size()
                area = int(((f["c1"] - f["c0"]).astype(np.int64)
                            * f["h"][f["bidx"]]).sum())
                bound += (esz * (int(f["h"].sum()) * As.shape[2]
                                 + b_op.numel()) + 4 * area) / PEAK_BW * 1e3
            fv.launches = n0 + calls
            row = {"gemm": name, "m": m, "n": n, "q": q, "dtype": dt,
                   "rects": len(rects), "buckets": len(runs),
                   "launches": calls, "max_rel_err": audit["max_rel_err"],
                   "worst_over_tol": audit["worst"],
                   "poisoned": len(poisoned),
                   "poisoned_flagged": len(flagged & poisoned),
                   "clean_flagged": len(flagged - poisoned),
                   "plain_poisoned_flagged": len(plain_flagged & poisoned),
                   "verdicts_equal_plain": flagged == plain_flagged,
                   "device_ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes"}
            rows.append(row)
            emit({"phase": "freivalds_gemm", **row})
            del audit, runs
            check(calls == row["buckets"],
                  f"freivalds: {calls} kernel calls for {row['buckets']} "
                  f"buckets of {name}")
            check(row["worst_over_tol"] <= 1.0, f"freivalds: {name} {dt} "
                  f"differs from plain by {row['worst_over_tol']:.3g} x "
                  "its tolerance")
            check(row["clean_flagged"] == 0 and row["verdicts_equal_plain"],
                  f"freivalds: {name} {dt} verdicts {row}")
            check(pol != "f32" or row["poisoned_flagged"] == len(poisoned),
                  f"freivalds: {name} f32 lets a poisoned rectangle pass")
        del A, B
    out = {"phase": "freivalds",
           "signs_bit_equal": all(p["signs_equal"] for p in probes),
           "sign_products_held": sum(p["sign_products"] for p in probes),
           "launches": sum(r["launches"] for r in rows),
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return {**out, "gemms": rows}


def _rel(a: float, b: float) -> float:
    """|a - b| over the larger magnitude (0 when both are 0)."""
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


def _levels_rel(a, b) -> float:
    check(len(a.level_times) == len(b.level_times),
          f"sim: {len(a.level_times)} level times against "
          f"{len(b.level_times)}")
    return max((_rel(x, y) for x, y in zip(a.level_times, b.level_times)),
               default=0.0)


def host_cpu() -> str:
    """The host's CPU as ``lscpu`` names it (vendor, model name, family and
    model; else the machine type) and its core count."""
    import platform
    fields = {}
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        fields = dict(ln.split(":", 1) for ln in out.splitlines()
                      if ":" in ln)
    name = ", ".join(f"{k} {fields[k].strip()}" for k in
                     ("Vendor ID", "Model name", "CPU family", "Model")
                     if k in fields)
    return f"{name or platform.machine()} ({os.cpu_count()} cores)"


# the 10,000-device row of the array engine's fleet-scaling bench: devices,
# DAG levels, items a chain, PS island size
BULK_ROW = (10_000, 6, 3, 64)


def sim_bulk_row():
    """``ArrayTimelineEngine.add_chains_bulk`` at 10,000 devices, as the
    reference's core bench builds its first fleet-scaling row: random
    devices (seed 7), per-island PS links sized just above the chains'
    peak rates, two failures and a slowdown, 6 levels of one 3-item chain a
    device (workloads seed 11); the run's events, wall and event rate."""
    import numpy as np
    from repro_torch.core.cost_model import Device
    from repro_torch.sim import events as ev
    from repro_torch.sim.engine_array import ArrayTimelineEngine
    n, n_levels, ipc, island = BULK_ROW
    rng = np.random.default_rng(7)
    devs = [Device(flops=float(f), dl_bw=float(dl), ul_bw=float(ul),
                   device_id=i)
            for i, (f, dl, ul) in enumerate(zip(
                rng.uniform(0.5e12, 4e12, n), rng.uniform(2e7, 2e8, n),
                rng.uniform(1e7, 1e8, n)))]
    eng = ArrayTimelineEngine(
        devs, ps_egress_bps=2e8 * island * 1.1,
        ps_ingress_bps=1e8 * island * 1.1,
        ps_of={i: i // island for i in range(n)},
        events=[ev.fail(0.05, device_id=3),
                ev.slowdown(0.07, device_id=11, factor=2.0),
                ev.fail(0.2, device_id=n // 2)])
    dids = np.arange(n)
    wl = np.random.default_rng(11)
    t0 = time.perf_counter()
    for lv in range(n_levels):
        eng.add_chains_bulk(dids, wl.uniform(1e5, 1e6, n),
                            wl.uniform(1e8, 1e9, n),
                            wl.uniform(5e4, 5e5, n), dl_lat=0.001,
                            ul_lat=0.002, level=lv, items_per_chain=ipc)
    t_build = time.perf_counter() - t0
    rep = eng.run()
    check(rep.n_failures == 2 and rep.makespan > 0
          and math.isfinite(rep.makespan),
          f"sim: the 10k-device bulk row {rep.n_failures} failures, "
          f"makespan {rep.makespan}")
    return {"devices": n, "levels": n_levels, "items_per_chain": ipc,
            "backend": rep.backend, "n_events": rep.n_events,
            "n_failures": rep.n_failures, "makespan_s": rep.makespan,
            "build_wall_s": t_build, "sim_wall_s": rep.wall_time,
            "events_per_sec": rep.events_per_sec}


def phase_sim():
    """The paper's cost model on the card's host (numpy; no tensor, no
    kernel), through the runtime built for the card: llama3-8b at full
    width and full depth priced analytically and replayed on the event and
    event-array engines at B 8 x S 128 on ``Fleet.sample(16, seed=0)``
    (train_full's fleet) and at B 128 x S 1024 on 512 devices -- the replay
    within 1e-6 of the closed form, the array engine within 1e-9 of the
    scalar one with and without a fail/join/slowdown script (the failure
    mid-work: both engines price a repair);
    ``stream_profile`` of its d_ff GEMM under Pareto(2) jitter; Table 8's
    llama2-13b row; the 10,000-device bulk row."""
    from repro_torch.api import Fleet, TorchCleaveRuntime, fail, join, slowdown
    from repro_torch.configs.base import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.sim import simulator as S
    t_phase = time.perf_counter()
    cfg = get_config("llama3-8b")
    joiner = cm.Device(flops=5e13, dl_bw=2e8, ul_bw=5e7, device_id=10_000)
    cells, runtimes = {}, {}
    for cell, (B, Sq, n_dev) in {"train_full_fleet": (8, 128, 16),
                                  "fleet512": (128, 1024, 512)}.items():
        rt = runtimes[cell] = TorchCleaveRuntime(
            arch=cfg, fleet=Fleet.sample(n_dev, seed=0))
        t0 = time.perf_counter()
        ana = rt.simulate(B, Sq, backend="analytic")
        t_ana = time.perf_counter() - t0
        det = rt.simulate(B, Sq, backend="event")
        arr = rt.simulate(B, Sq, backend="event-array")
        busy = sorted(det.device_busy, key=det.device_busy.get)
        mk = det.makespan
        rest = [slowdown(mk * 0.1, busy[-2], 4.0),
                slowdown(mk * 0.6, busy[-2], 0.25), join(mk * 0.05, joiner)]
        # the busiest device fails mid-work, so that its repair is priced:
        # a thousandth into the level in flight at 0.3 of the makespan,
        # when every chain of that level has started (the levels' opening
        # times from a traced replay of the other events, which is the
        # scenario's timeline up to the failure)
        traced = rt.simulate(B, Sq, backend="event", events=rest,
                             trace=True)
        opens = [t for t, kind, _ in traced.trace if kind == "level"]
        lv = bisect.bisect_right(opens, mk * 0.3) - 1
        t_fail = opens[lv] + 1e-3 * ((opens + [traced.gemm_time])[lv + 1]
                                     - opens[lv])
        evs = [fail(t_fail, busy[-1])] + rest
        sca_ev = rt.simulate(B, Sq, backend="event", events=evs)
        arr_ev = rt.simulate(B, Sq, backend="event-array", events=evs)
        row = {
            "devices": n_dev, "batch": [B, Sq], "n_layers": cfg.n_layers,
            "analytic_s": ana.makespan, "event_s": det.makespan,
            "event_vs_analytic": max(_rel(det.makespan, ana.makespan),
                                     _levels_rel(det, ana)),
            "array_vs_event": max(_rel(arr.makespan, det.makespan),
                                  _levels_rel(arr, det)),
            "n_levels": len(det.level_times), "n_events": det.n_events,
            "analytic_wall_s": t_ana, "event_wall_s": det.wall_time,
            "event_array_wall_s": arr.wall_time,
            "event_events_per_sec": det.events_per_sec,
            "event_array_events_per_sec": arr.events_per_sec,
            "scenario": {
                "fail_at_s": t_fail, "fail_level": lv,
                "makespan_s": sca_ev.makespan,
                "recovery_latency_s": sca_ev.recovery_latency,
                "recomputed_fraction": sca_ev.recomputed_fraction,
                "counts": [sca_ev.n_failures, sca_ev.n_joins,
                           sca_ev.n_slowdowns],
                "array_vs_event": max(
                    _rel(arr_ev.makespan, sca_ev.makespan),
                    _levels_rel(arr_ev, sca_ev),
                    _rel(arr_ev.recovery_latency, sca_ev.recovery_latency)),
                "event_wall_s": sca_ev.wall_time,
                "event_array_wall_s": arr_ev.wall_time,
                "n_events": sca_ev.n_events}}
        cells[cell] = row
        emit({"phase": "sim_cell", "cell": cell, **row})
        check(row["event_vs_analytic"] <= 1e-6,
              f"sim {cell}: the event replay {row['event_vs_analytic']} "
              "off the closed form")
        check(row["array_vs_event"] <= 1e-9
              and row["scenario"]["array_vs_event"] <= 1e-9,
              f"sim {cell}: the array engine off the scalar one: {row}")
        check(row["scenario"]["counts"] == [1, 1, 2],
              f"sim {cell}: scenario events {row['scenario']['counts']}")
        check(sca_ev.recovery_latency > 0 and arr_ev.recovery_latency > 0,
              f"sim {cell}: the failure priced no repair (recovery "
              f"latency {sca_ev.recovery_latency}, array "
              f"{arr_ev.recovery_latency})")
    d_ff = cm.GEMM(m=8 * 128, n=cfg.d_model, q=cfg.d_ff)
    st = runtimes["train_full_fleet"].stream_profile(d_ff, pareto_alpha=2.0)
    stream = {"gemm": [d_ff.m, d_ff.n, d_ff.q], "pareto_alpha": 2.0,
              "serial_s": st.serial_time, "pipelined_s": st.pipelined_time,
              "jittered_s": st.jittered_time,
              "overlap_speedup": st.overlap_speedup}
    check(all(math.isfinite(v) and v > 0 for v in
              (st.serial_time, st.pipelined_time, st.jittered_time))
          and st.overlap_speedup > 1.0, f"sim: stream_profile {stream}")
    t0 = time.perf_counter()
    table8 = S.compare_systems("llama2-13b", 128, 1024, 512)
    table8["wall_s"] = time.perf_counter() - t0
    check(table8["cleave"] < table8["dtfm"] < table8["alpa"]
          and abs(table8["cloud"] - 33.6) / 33.6 < 0.05,
          f"sim: Table 8's row {table8}")
    bulk = sim_bulk_row()
    cpu = host_cpu()
    out = {"cells": cells, "stream_profile": stream, "table8": table8,
           "bulk_10k": bulk, "host_cpu": cpu,
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "sim", "stream_profile": stream, "table8": table8,
          "bulk_10k": bulk, "host_cpu": cpu, "phase_s": out["phase_s"]})
    return out


# scripts/check_docs.py's smoke arguments for examples/train_e2e.py
E2E_SMOKE = ["--steps", "2", "--layers", "2", "--d-model", "128", "--vocab",
             "512", "--batch", "2", "--seq", "64"]
EXAMPLE_RUNS = (
    ("quickstart", []), ("churn_recovery", []), ("edge_simulation", []),
    ("fleet_timeline", []), ("torch_executor_level", []),
    ("serve_decode", []), ("serve_decode", ["--dtype-policy", "f32"]),
    ("train_e2e", E2E_SMOKE),
    ("train_e2e", E2E_SMOKE + ["--backend", "fleet", "--fail-step", "1"]),
    ("train_multi_ps", []))
# the kernels each run must launch (the rest may launch too)
EXAMPLE_KERNELS = {
    "quickstart": ("band_gemm",), "churn_recovery": ("band_gemm",),
    "torch_executor_level": ("band_gemm",),
    "serve_decode": ("band_gemm", "flash_attention", "flash_decode"),
    "serve_decode_f32": ("band_gemm", "flash_attention", "flash_decode"),
    "train_e2e": ("flash_attention",),
    "train_e2e_fleet": ("band_gemm", "flash_attention"),
    "train_multi_ps": ("band_gemm", "flash_attention")}


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}",
        os.path.join(ROOT, "examples_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_checks(name: str, fig: dict) -> dict:
    """The example's own bars; returns the figures its line reports."""
    import numpy as np
    tol = 1e-5
    if name in ("quickstart", "churn_recovery"):
        step, step2 = fig["step"], fig["step2"]
        row = {"err": fig["err"], "err_after_churn": fig["err2"],
               "n_tasks": step.n_tasks, "n_recovered": step.n_recovered,
               "kernel": step.kernel, "warm_plan_cached": step2.plan_cached}
        ok = (fig["err"] <= tol and fig["err2"] <= tol and step.verified
              and step2.verified and step.n_recovered > 0
              and step2.plan_cached and step.kernel == step2.kernel == "cuda")
    elif name == "edge_simulation":
        row = {k: fig["table8"][k] for k in ("cleave", "dtfm", "alpa",
                                            "cloud")}
        ok = all(math.isfinite(v) for v in row.values())
    elif name == "fleet_timeline":
        row = {"analytic_s": fig["analytic"].makespan,
               "event_s": fig["deterministic"].makespan,
               "failure_s": fig["failure"].makespan,
               "jitter_s": fig["jitter"].makespan}
        ok = _rel(row["analytic_s"], row["event_s"]) <= 1e-6
    elif name == "torch_executor_level":
        lev, step, batch = fig["level"], fig["step"], fig["batch"]
        row = {"parity": fig["parity"], "err": fig["err"],
               "n_tasks": lev.n_tasks, "n_recovered": step.n_recovered,
               "batch_levels": batch.n_levels, "batch_tasks": batch.n_tasks}
        ok = (fig["parity"] <= tol and fig["err"] <= tol and lev.verified
              and step.verified and step.n_recovered > 0 and batch.verified
              and all(s.kernel == "cuda" for s in lev.steps + [step]))
    elif name in ("serve_decode", "serve_decode_f32"):
        rep = fig["report"]
        row = {"n_requests": rep.n_requests, "n_tokens": rep.n_tokens,
               "n_steps": rep.n_steps, "n_recovered": rep.n_recovered,
               "tokens_per_sec": rep.tokens_per_sec,
               "tokens_per_sec_priced": rep.tokens_per_sec_priced,
               "pages_in_use": rep.cache.n_used}
        ok = (rep.n_requests == 6 and rep.n_tokens == 36
              and rep.n_recovered > 0 and rep.cache.n_used == 0
              and all(s.verified for s in fig["steps"]))
        if name == "serve_decode_f32":
            # under the f32 policy every request's tokens equal the
            # port's token-by-token monolithic decoding of its prompt
            import torch
            from repro_torch import ieee_f32
            ieee_f32()
            sess = fig["session"]
            got = {r.rid: list(r.tokens) for r in fig["finished"]}
            want = {r.rid: _monolithic_greedy(
                        sess.cfg, sess.params, r.prompt, r.max_new,
                        sess.cache_len, torch.device("cuda"))
                    for r in fig["finished"]}
            row["tokens_match_monolithic"] = got == want
            check(got == want, f"examples {name}: tokens {got} != "
                  f"monolithic {want}")
    elif name == "train_e2e":
        hist = fig["history"]
        row = {"loss": [h["loss"] for h in hist]}
        ok = len(hist) == 2 and all(np.isfinite(row["loss"]))
    elif name == "train_e2e_fleet":
        hist = fig["history"]
        row = {"loss": [h["loss"] for h in hist],
               "tasks": [h["fleet_tasks"] for h in hist],
               "recovered": [h["fleet_recovered"] for h in hist],
               "cache_hit_rate": [h["fleet_cache_hit_rate"] for h in hist]}
        ok = (len(hist) == 2 and all(np.isfinite(row["loss"]))
              and all(h["fleet_verified"] for h in hist)
              and hist[1]["fleet_recovered"] > 0
              and hist[1]["fleet_cache_hit_rate"] == 1.0)
    else:                                   # train_multi_ps
        reps = fig["reports"]
        row = {"rounds": fig["rounds"], "inner_steps": fig["inner_steps"],
               "n_islands": fig["n_islands"], "loss": fig["loss"],
               "sync_bytes": sum(r.cross_ps_sync_bytes for r in reps)}
        ok = ((fig["rounds"], fig["inner_steps"], fig["n_islands"])
              == (2, 4, 2) and math.isfinite(fig["loss"])
              and all(i.verified for r in reps for i in r.island_reports))
    check(ok, f"examples {name}: {row}")
    return row


def phase_examples():
    """Every ported example's ``main`` on the card, at the reference's
    sizes (train_e2e at ``scripts/check_docs.py``'s smoke arguments, on
    the monolithic backend and on the fleet with a failure; serve_decode
    also under the f32 policy, its tokens against monolithic decoding),
    each example's bars checked, every band GEMM and attention launch held
    against its plain version, and the kernels' launches counted around
    each run."""
    import torch
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6
    t_phase = time.perf_counter()
    totals = collections.Counter()
    rows = {}
    worst = 0.0
    worst_attn = dict.fromkeys(ATTENTION_KERNELS, 0.0)
    shapes_attn = {k: collections.Counter() for k in ATTENTION_KERNELS}
    for name, argv in EXAMPLE_RUNS:
        run = name + ("_fleet" if "fleet" in argv else "") \
            + ("_f32" if "--dtype-policy" in argv else "")
        mod = load_example(name)
        bg.launches = bg.batched_launches = bg.block_gemm_launches = 0
        dec.launches = dec.flash_decode_launches = 0
        fa.launches = wkv6.launches = 0
        reset_body_counts()
        mark = residual_mark()
        t0 = time.perf_counter()
        with band_gemm_audit(verify=True) as audit, \
                attention_audit() as attn:
            fig = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"band_gemm": bg.launches, "paged_decode": dec.launches,
                  "freivalds": residual_since(mark, "examples")[
                      "freivalds_launches"],
                  "flash_attention": fa.launches,
                  "flash_decode": dec.flash_decode_launches,
                  "block_gemm_batched": bg.batched_launches,
                  "block_gemm": bg.block_gemm_launches,
                  "wkv6": wkv6.launches}
        bodies = check_bodies(f"examples {run}", audit)
        check(audit["checked"] == counts["band_gemm"],
              f"examples {run}: {audit['checked']} band GEMM launches "
              f"checked of {counts['band_gemm']}")
        for k in ATTENTION_KERNELS:
            check(attn[k]["checked"] == counts[k],
                  f"examples {run}: {attn[k]['checked']} {k} launches "
                  f"checked of {counts[k]}")
            worst_attn[k] = max(worst_attn[k], attn[k]["max_rel_err"])
            shapes_attn[k].update(attn[k]["shapes"])
        missing = [k for k in EXAMPLE_KERNELS.get(run, ()) if not counts[k]]
        check(not missing, f"examples {run}: no launch of {missing}")
        worst = max(worst, audit["max_rel_err"])
        rows[run] = {"wall_s": wall, "launches": counts, "bodies": bodies,
                     "band_gemm_max_rel_vs_plain": audit["max_rel_err"],
                     **{f"{k}_max_rel_vs_plain": attn[k]["max_rel_err"]
                        for k in ATTENTION_KERNELS if counts[k]},
                     **_example_checks(run, fig)}
        totals.update(counts)
        emit({"phase": "example", "name": run, **rows[run]})
    max_rel = {"band_gemm": worst, **worst_attn}
    shapes = {k: [[list(sh), n] for sh, n in shapes_attn[k].items()]
              for k in ATTENTION_KERNELS}
    out = {"launches": dict(totals), "runs": rows, "max_rel_vs_plain":
           max_rel, "attention_shapes": shapes,
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "examples", "launches": out["launches"],
          "max_rel_vs_plain": max_rel, "attention_shapes": shapes,
          "phase_s": out["phase_s"]})
    return out


# ------------------------------------------------------------------- mesh --

# mesh_reduced's train-step cases: (arch, mesh dims, config overrides);
# the capacity factor of 2 holds every routed token of the reduced MoE
# (4 experts, top 2), so the sharded and the global routing drop none
MESH_STEP_CASES = (("llama3-8b", (2, 2), None),
                   ("granite-moe-1b-a400m", (2, 2), None),
                   ("llama3-8b", (2, 1, 2), None),
                   ("granite-moe-1b-a400m", (2, 1, 2), None),
                   ("granite-moe-1b-a400m", (2, 2),
                    {"capacity_factor": 2.0}))
MESH_STRICT = 1e-5
# the other families, each held sharded against single-device on 2x2
# (``launch.mesh_check.family_parity``): loss and decode logits within
# MESH_STRICT, each gradient leaf within FAMILY_GRAD_L2 in relative L2,
# the bar the CPU parity tests hold RWKV, MoE, MLA and hymba params to:
# a rank runs the recurrences on its batch rows, whose products the card
# sums in another order than the whole batch's, and RWKV's smallest
# gradient leaves read 4e-5 there (NVIDIA H100 80GB HBM3, 700.00 W; 1e-6
# on the CPU)
FAMILY_GRAD_L2 = 1e-4
MESH_FAMILIES = ("deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b",
                 "qwen2-vl-72b", "seamless-m4t-medium", "qwen3-32b",
                 "phi3-medium-14b", "qwen1.5-32b")


def _mesh_rank_checks(rank, device="cuda"):
    """One rank of mesh_reduced's threaded group: the train-step cases
    (``launch.mesh_check.rank_body``), then the sharded MoE against the
    global path, the sharded decode against the unsharded one, and
    prefill then serve under decode rules against the unsharded port
    (``device``: the card; the CPU for a rehearsal)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import mesh_check as MC
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps as ST
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import (make_rules, placements,
                                               use_rules)
    dev = torch.device(device)
    out = {"steps": [dict(MC.rank_body(rank, 4, arch, dims, device, over),
                          over=over)
                     for arch, dims, over in MESH_STEP_CASES]}
    mesh = MC.mesh_of((2, 2), device)
    gen = torch.Generator(device=dev).manual_seed(5)

    def put(t, spec, rules):
        return distribute_tensor(t, mesh, placements(spec, rules.mesh),
                                 src_data_rank=None)

    # the sharded MoE on the global path's tokens, no token dropped
    cfg = MC.reduced_config("granite-moe-1b-a400m", capacity_factor=2.0)
    rules = make_rules(mesh, "train")
    p = M.init_params(cfg, gen)["layers"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((4, 8, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        want, aux_w = MOE._moe_block_global(cfg, p, x)
        with use_rules(rules):
            dp = {k: put(v, SP._leaf_spec("moe/" + k, v.shape, rules),
                         rules) for k, v in p.items()}
            got, aux_g = MOE.moe_block(cfg, dp, put(x, ("data", None,
                                                        "model"), rules))
            got, aux_g = got.full_tensor(), aux_g.full_tensor()
    out["moe_rel"] = float((got - want).abs().max() / want.abs().max())
    out["moe_aux_rel"] = float((aux_g - aux_w).abs() / aux_w.abs())

    # the sharded decode (cache sequence on 'model') against the unsharded
    B, S, H, K, D, slot = 4, 64, 8, 2, 64, 37
    q = torch.randn((B, 1, H, D), generator=gen, device=dev)
    kn, vn = (torch.randn((B, 1, K, D), generator=gen, device=dev)
              for _ in range(2))
    ck, cv = (torch.randn((B, S, K, D), generator=gen, device=dev)
              for _ in range(2))
    valid = torch.arange(S, device=dev) < slot + 1
    drules = make_rules(mesh, "decode")
    with torch.no_grad():
        wk, wv = ck.clone(), cv.clone()
        wk[:, slot], wv[:, slot] = kn[:, 0], vn[:, 0]
        want = A.decode_attention(q, wk, wv, valid)
        with use_rules(drules):
            st = torch.tensor(slot, device=dev)
            got = A.decode_attention(
                put(q, ("data",), drules),
                A._write_slot(put(ck, ("data", "model"), drules),
                              put(kn, ("data",), drules), st),
                A._write_slot(put(cv, ("data", "model"), drules),
                              put(vn, ("data",), drules), st),
                valid).full_tensor()
    out["decode_rel"] = float((got - want).abs().max() / want.abs().max())

    # prefill, then serve under decode rules, against the unsharded port
    cfg = MC.reduced_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (4, 8), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, {"tokens": tok})
        want = [logits[:, -1].argmax(-1)]
        for _ in range(3):
            logits, cache = M.decode_step(cfg, params, cache,
                                          want[-1][:, None])
            want.append(logits[:, -1].argmax(-1))
    prules = make_rules(mesh, "prefill")
    cpl = {n: placements(SP._divisible_spec(
        drules, t.shape, [None if x == "layers" else x
                          for x in SP.CACHE_LOGICAL[n]]), mesh)
        for n, t in cache.items()}
    prefill = ST.make_prefill_step(cfg, rules=prules, cache_placements=cpl)
    serve = ST.make_serve_step(cfg, rules=drules)
    logits, dcache = prefill(SP.shard_params(params, prules),
                             {"tokens": put(tok, ("data", None), prules)})
    got = [logits.full_tensor()[:, -1].argmax(-1)]
    dparams = SP.shard_params(params, drules)
    for _ in range(3):
        logits, dcache = serve(dparams, dcache,
                               put(got[-1][:, None], ("data", None),
                                   drules))
        got.append(logits.full_tensor()[:, -1].argmax(-1))
    out["serve_tokens_equal"] = all(torch.equal(a, b)
                                    for a, b in zip(got, want))
    out["serve_tokens"] = [t.tolist() for t in got]
    out["families"] = {a: MC.family_parity(a, device) for a in MESH_FAMILIES}
    return out


def phase_mesh_reduced():
    """The mesh layer's checks on four ranks sharing the card: every B2
    and B4 launch of the run held against its plain version (the audits
    wrap the kernels for every rank thread)."""
    import torch
    from repro_torch import ieee_f32
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh_check as MC
    ieee_f32()
    torch.cuda.set_device(0)
    bg.batched_launches = fa.launches = dec.flash_decode_launches = 0
    t0 = time.perf_counter()
    with band_gemm_audit(verify=True, entry="block_gemm_batched") as b2, \
            attention_audit() as attn:
        res = MC.run_threaded(4, _mesh_rank_checks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"block_gemm_batched": bg.batched_launches,
                "flash_attention": fa.launches,
                "flash_decode": dec.flash_decode_launches}
    steps = [{k: r[k] for k in ("arch", "mesh", "over", "loss_single",
                                "loss_mesh", "loss_rel",
                                "params_worst_rel_l2", "params_allclose",
                                "ok", "backend")} for r in res["steps"]]
    row = {"phase": "mesh_reduced", "group": "threaded", "ranks": 4,
           "wall_s": wall, "steps": steps, "moe_rel": res["moe_rel"],
           "moe_aux_rel": res["moe_aux_rel"],
           "decode_rel": res["decode_rel"],
           "serve_tokens_equal": res["serve_tokens_equal"],
           "families": res["families"],
           "launches": launches, "b2_checked": b2["checked"],
           "b2_max_rel_err": b2["max_rel_err"],
           "b4_checked": attn["flash_attention"]["checked"],
           "b4_max_rel_err": attn["flash_attention"]["max_rel_err"],
           "b5_checked": attn["flash_decode"]["checked"],
           "b5_max_rel_err": attn["flash_decode"]["max_rel_err"]}
    emit(row)
    for r in steps:
        check(r["ok"], f"mesh_reduced {r['arch']} {r['mesh']}: {r}")
        if r["arch"] == "llama3-8b" or r["over"]:
            check(r["loss_rel"] <= MESH_STRICT
                  and r["params_worst_rel_l2"] <= MESH_STRICT,
                  f"mesh_reduced {r['arch']} {r['mesh']} off 1e-5: {r}")
    check(res["moe_rel"] <= MESH_STRICT and res["moe_aux_rel"] <= MESH_STRICT,
          f"mesh_reduced: sharded MoE off the global path {row}")
    check(res["decode_rel"] <= MESH_STRICT,
          f"mesh_reduced: sharded decode off {row}")
    check(res["serve_tokens_equal"], f"mesh_reduced: serve tokens {row}")
    for arch, r in res["families"].items():
        check(r["loss_rel"] <= MESH_STRICT and r["decode_rel"] <= MESH_STRICT
              and r["grad_rel"] <= FAMILY_GRAD_L2,
              f"mesh_reduced {arch}: sharded off single-device {r}")
    check(launches["block_gemm_batched"] > 0
          and launches["flash_attention"] > 0
          and b2["checked"] == launches["block_gemm_batched"]
          and attn["flash_attention"]["checked"]
          == launches["flash_attention"]
          and attn["flash_decode"]["checked"] == launches["flash_decode"],
          f"mesh_reduced: launches {launches}, checked {b2['checked']} "
          f"B2, {attn['flash_attention']['checked']} B4, "
          f"{attn['flash_decode']['checked']} B5")
    return row


# mesh_full's cases: (arch, shape, multi-pod, layers or None for the
# config's own depth).  deepseek-v2-236b runs 16 of its 60 layers: its 16
# microbatches take ~3.6 s a layer on rank 0 (at full depth the step took
# 228 s and peaked at 19.6 GB on an NVIDIA H100 80GB HBM3, 700.00 W), and
# at 30 layers the whole script took 763 s of its 1200, past the half of
# its limit that it keeps to
MESH_FULL_CASES = (("llama3-8b", "train_4k", False, None),
                   ("llama3-8b", "decode_32k", False, None),
                   ("granite-moe-1b-a400m", "train_4k", True, None),
                   ("deepseek-v2-236b", "train_4k", False, 16))


def _host_rss_gb(who=None) -> float:
    """Peak resident host memory (GB) of this process, or of its finished
    children with ``who="children"``."""
    import resource
    r = resource.getrusage(resource.RUSAGE_CHILDREN if who == "children"
                           else resource.RUSAGE_SELF)
    return r.ru_maxrss / 1e6


def _layout(t) -> list:
    return [list(t.shape), list(t.stride()), str(t.dtype).rsplit(".", 1)[-1]]


@contextlib.contextmanager
def launch_recorder():
    """Wraps the B2, B4 and B5 wrappers while a path runs and counts each
    launch by its signature: every operand's shape, strides and type, and
    B4's mask flags.  Nothing is compared here: after a fake collective
    the data mean nothing (:func:`check_launch_signatures` holds each
    signature to its plain version on fresh data instead)."""
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    sigs = {"B2": collections.Counter(), "B4": collections.Counter(),
            "B5": collections.Counter()}
    real = (bg.block_gemm_batched, fa.attend, dec.flash_decode)

    def block_gemm_batched(a, b):
        n = bg.batched_launches
        c = real[0](a, b)
        if bg.batched_launches > n:
            sigs["B2"][json.dumps([_layout(a), _layout(b)])] += 1
        return c

    def attend(q, k, v, out, *, causal=True, window=0, q_offset=0,
               prefix=0, _block_q=None):
        n = fa.launches
        real[1](q, k, v, out, causal=causal, window=window,
                q_offset=q_offset, prefix=prefix, _block_q=_block_q)
        if fa.launches > n:
            sigs["B4"][json.dumps([_layout(q), _layout(k), _layout(v),
                                   _layout(out), bool(causal), int(window),
                                   int(q_offset), int(prefix)])] += 1
        return out

    def flash_decode(q, k_cache, v_cache, valid, *, _split=None):
        n = dec.flash_decode_launches
        got = real[2](q, k_cache, v_cache, valid, _split=_split)
        if dec.flash_decode_launches > n:
            sigs["B5"][json.dumps([_layout(q), _layout(k_cache)])] += 1
        return got

    bg.block_gemm_batched, fa.attend = block_gemm_batched, attend
    dec.flash_decode = flash_decode
    try:
        yield sigs
    finally:
        bg.block_gemm_batched, fa.attend, dec.flash_decode = real


def mesh_full_case(arch, shape, multi_pod, layers, out_path):
    """One mesh_full case, in a process of its own: ``python -m
    repro_torch.launch.dryrun``'s ``main`` for rank 0 on the card, with
    every B2, B4 and B5 launch's signature recorded; writes the dry run's
    result with the signatures to ``out_path``."""
    from repro_torch.launch import dryrun
    argv = ["--arch", arch, "--shape", shape, "--out", out_path]
    argv += ["--multi-pod"] if multi_pod == "1" else []
    argv += ["--layers", layers] if layers != "0" else []
    with launch_recorder() as sigs:
        rc = dryrun.main(argv)
    with open(out_path) as f:
        res = json.load(f)
    res[0]["launch_signatures"] = {k: dict(v) for k, v in sigs.items()}
    with open(out_path, "w") as f:
        json.dump(res, f)
    return rc


def _strided_randn(layout, gen, dev, scale=1.0):
    """A tensor of a recorded layout (shape, strides, type), filled with
    N(0, scale^2)."""
    import torch
    shape, stride, dt = layout
    t = torch.empty_strided(shape, stride, dtype=torch.float32, device=dev)
    t.copy_(torch.randn(shape, generator=gen, device=dev) * scale)
    return t.to(getattr(torch, dt))


def check_launch_signatures(sigs, what: str) -> dict:
    """Each recorded B2 and B4 signature (:func:`launch_recorder`) run
    once on fresh inputs of its layout, kernel against plain version: B2
    within 1e-5 of the largest output (both sum exact products in f32),
    B4 within 1e-5 in f32 and one bf16 ulp (2^-7) in bf16.  B5 must not
    have launched (nothing here rebuilds its validity mask).  Returns per
    kernel the signatures checked and the worst relative error."""
    import torch
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    check(not sigs["B5"], f"{what}: B5 launched, its launches unchecked "
          f"{sigs['B5']}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    res = {k: {"signatures": len(sigs[k]), "checked": 0, "max_rel_err": 0.0}
           for k in ("B2", "B4")}

    def hold(kernel, got, want, sig, tol):
        scale = max(float(want.float().abs().max()), 1e-30)
        rel = float((got.float() - want.float()).abs().max()) / scale
        check(rel <= tol, f"{what}: {kernel} launch {sig}: rel err "
              f"{rel:.3g} against the plain version (limit {tol:g})")
        res[kernel]["checked"] += 1
        res[kernel]["max_rel_err"] = max(res[kernel]["max_rel_err"], rel)

    with torch.no_grad():
        for sig in sigs["B2"]:
            la, lb = json.loads(sig)
            a = _strided_randn(la, gen, dev)
            b = _strided_randn(lb, gen, dev, la[0][-1] ** -0.5)
            hold("B2", bg.block_gemm_batched(a, b),
                 bg.block_gemm_batched_plain(a, b), sig, 1e-5)
            del a, b
        for sig in sigs["B4"]:
            lq, lk, lv, lo, causal, window, q_offset, prefix = \
                json.loads(sig)
            q, k, v = (_strided_randn(x, gen, dev) for x in (lq, lk, lv))
            out = _strided_randn(lo, gen, dev)
            flags = dict(causal=causal, window=window, q_offset=q_offset,
                         prefix=prefix)
            fa.attend(q, k, v, out, **flags)
            want = fa._attend_plain(q, k, v, **flags)
            hold("B4", out, want, sig,
                 1e-5 if out.dtype == torch.float32 else BF16_OUT_TOL)
            del q, k, v, out, want
            torch.cuda.empty_cache()
    return res


def phase_mesh_full():
    """Rank 0 of each production-mesh case run on the card by
    ``python -m repro_torch.launch.dryrun``'s ``main``, one process a case
    (each starts from a clean card and host), with its measured peak,
    cost terms, step time and device idle share; then every B2 and B4
    signature the case launched held to its plain version here."""
    import tempfile

    import torch
    rows = {}
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.mesh_full_case(*sys.argv[2:]))")
    for arch, shape, multi_pod, layers in MESH_FULL_CASES:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out.json")
            cmd = [sys.executable, "-c", code, ROOT, arch, shape,
                   str(int(multi_pod)), str(layers or 0), out]
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=600)
            check(proc.returncode == 0, f"mesh_full {arch} {shape}: "
                  f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
            with open(out) as f:
                r = json.load(f)[0]
        sigs = r["launch_signatures"]
        recorded = {k: sum(v.values()) for k, v in sigs.items()}
        checked = check_launch_signatures(sigs, f"mesh_full {arch} {shape}")
        row = {"phase": "mesh_full", "arch": arch, "shape": shape,
               "mesh": r["mesh"], "axes": r["axes"], "mode": r["mode"],
               "n_layers": r["n_layers"],
               "peak_per_device": r["memory"]["peak_per_device"],
               "hbm_bytes": r["memory"]["hbm_bytes"],
               "fits_hbm": r["memory"]["fits_hbm"],
               "flops": r["cost"]["flops"], "bytes": r["cost"]["bytes"],
               "kernel_flops": r["cost"]["kernel_flops"],
               "collectives": r["collectives"],
               "collective_bytes": r["collective_bytes"],
               "roofline": r["roofline"], "dominant": r["dominant"],
               "model_flops_per_device": r["model_flops_per_device"],
               "useful_flops_ratio": r["useful_flops_ratio"],
               "step_ms": r["step_ms"], "device_busy_ms": r["device_busy_ms"],
               "device_idle_share": r["device_idle_share"],
               "step_s": r["step_s"], "build_s": r["build_s"],
               "launches": {"B2": r["launches"]["B2"],
                            "B4": r["launches"]["B4"],
                            "B5": r["launches"]["B5"]},
               "signatures_checked": checked,
               "host_rss_gb_children_peak": _host_rss_gb("children"),
               "host_rss_gb_parent_peak": _host_rss_gb()}
        emit(row)
        rows[f"{arch}_{shape}"] = row
        check(row["peak_per_device"] > 0 and row["flops"] > 0
              and row["collective_bytes"] > 0,
              f"mesh_full {arch} {shape}: empty measurement {row}")
        check(recorded == row["launches"]
              and all(c["checked"] == c["signatures"]
                      for c in checked.values()),
              f"mesh_full {arch} {shape}: launches {row['launches']}, "
              f"recorded {recorded}, signatures checked {checked}")
        check(row["launches"]["B4"] > 0 or shape == "decode_32k",
              f"mesh_full {arch} {shape}: no attention launch {row}")
        if arch.startswith(("granite", "deepseek")):
            check(row["launches"]["B2"] > 0,
                  f"mesh_full {arch} {shape}: no expert launch {row}")
    return rows


def profiled_step(step):
    """Runs ``step()`` once under ``torch.profiler`` (the card's activity
    only); returns (its wall seconds, the seconds of device activity it
    launched: kernels, copies and fills).  The raw events are summed
    without the profiler's per-op post-processing, which takes minutes
    over a full-depth step's launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not e.is_user_annotation())
    return wall, ns / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--src", default="",
                    help="the src directory whose repro_torch to import "
                         "(default: this checkout's), to time an older "
                         "tree's kernels (the f32sets and attnsets "
                         "phases)")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    full = dataclasses.replace(get_config("llama3-8b"), n_layers=4)
    rwkv_full = dataclasses.replace(get_config("rwkv6-7b"), n_layers=4)
    moe_full = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                                   n_layers=4)
    # one layer: its 5.0 B params with the embedding and head, bf16, with
    # their grads and f32 moments take 60 GB of the card's 80
    mla_full = dataclasses.replace(get_config("deepseek-v2-236b"),
                                   n_layers=1)
    # three layers: 5.12 B params with the embedding and head, bf16, with
    # their grads and f32 moments take 61.5 GB; seamless at full depth
    mrope_full = dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=3)
    encdec_full = get_config("seamless-m4t-medium")
    # full depth: 1.64 B params, ~20 GB with grads and f32 moments
    hymba_full = get_config("hymba-1.5b")

    if "build" in phases:
        phase_build()
    gemm = phase_gemm(full) if "gemm" in phases else None
    paged = phase_paged() if "paged" in phases else None
    flash = phase_flash() if "flash" in phases else None
    decode = phase_decode() if "decode" in phases else None
    wkv = phase_wkv() if "wkv" in phases else None
    if "reduced" in phases:
        phase_reduced()
    launches = phase_full(full) if "full" in phases else None
    cells = {}                    # the f32-policy cells' launch sets
    if "train_reduced" in phases:
        cells["train_reduced"] = phase_train_reduced()
    train = phase_train_full(full) if "train_full" in phases else None
    if "rwkv_reduced" in phases:
        cells["rwkv_reduced"] = phase_rwkv_reduced()
    rwkv = phase_rwkv_full(rwkv_full) if "rwkv_full" in phases else None
    bgemm = phase_bgemm(moe_full) if "bgemm" in phases else None
    if "moe_reduced" in phases:
        cells["moe_reduced"] = phase_moe_reduced()
    moe = phase_moe_full(moe_full) if "moe_full" in phases else None
    if "mla_reduced" in phases:
        cells["mla_reduced"] = phase_moe_reduced("mla_reduced")
    mla = phase_mla_full(mla_full) if "mla_full" in phases else None
    for cell in ("mrope_reduced", "encdec_reduced"):
        if cell in phases:
            cells[cell] = phase_family_reduced(cell)
    mrope = phase_family_full(mrope_full) if "mrope_full" in phases \
        else None
    encdec = phase_family_full(encdec_full) if "encdec_full" in phases \
        else None
    if "hymba_reduced" in phases:
        cells["hymba_reduced"] = phase_family_reduced("hymba_reduced")
    hymba = phase_family_full(hymba_full) if "hymba_full" in phases \
        else None
    multips_r = phase_multips_reduced() if "multips_reduced" in phases \
        else None
    multips = phase_multips_full(full) if "multips_full" in phases else None
    batch = phase_batch(full) if "batch" in phases else None
    if "sim" in phases:
        phase_sim()
    examples = phase_examples() if "examples" in phases else None
    mesh_r = phase_mesh_reduced() if "mesh_reduced" in phases else None
    mesh_f = phase_mesh_full() if "mesh_full" in phases else None
    fv = phase_freivalds() if "freivalds" in phases else None
    if "split" in phases:
        phase_split()
    if "f32sets" in phases:
        phase_f32sets(moe_full)
    if "attnsets" in phases:
        phase_attnsets()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if all(x is not None for x in (gemm, paged, flash, decode, wkv,
                                   launches, train, rwkv, bgemm, moe,
                                   mla, mrope, encdec, hymba, multips_r,
                                   multips, batch, examples, mesh_r,
                                   mesh_f, fv)) \
            and len(cells) == 7:
        train_launches, gset = train
        ex = examples["launches"]
        dec_serve, dec_long = (decode["timed"]["serving_float32"],
                               decode["timed"]["cache32k_bfloat16"])
        paged_main = paged["timed"]["main_path_float32"]
        timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
        # the block GEMM sets with the host's gaps between calls hidden
        device = ("device_ms", "library_device_ms")
        b2_train, b2_dec, b3 = (bgemm["train_step"], bgemm["decode_step"],
                                bgemm["block_gemm"])
        b2_dec32 = bgemm["decode_step_f32"]
        set_keys = ("launches",) + timed[1:] + device

        def f32_set(cell, key="band_gemm_step"):
            return {k: cells[cell][key][k] for k in set_keys}
        kernels = [
            {"name": "band_gemm", "route": "cuda",
             "source": "src/repro_torch/csrc/band_gemm.cu",
             "replaces": "src/repro/kernels/block_gemm.py:59",
             "redesigned": "bf16: wgmma/TMA; f32: wide and skinny "
                           "cp.async FMA tilings",
             "launches": train_launches["band_gemm"],
             "launches_serving": launches["band_gemm"],
             "launches_by_body": train_launches["band_gemm_bodies"],
             "launches_by_body_serving": launches["band_gemm_bodies"],
             "split_k_bitwise_repeats": gemm["split_k_bitwise_repeats"],
             "ms_of": f"the {gset['launches']} launches of the first "
                      "full-width training step",
             "max_abs_err": gset["max_abs_err"], "ms": gset["ms"],
             "plain_ms": gset["plain_ms"], "bound_ms": gset["bound_ms"],
             "bound_by": gset["bound_by"],
             "library_ms": gset["library_ms"],
             **{k: gset[k] for k in device},
             "serving_step": {
                 "ms_of": "the 29 launches of one full-width decode step",
                 **{k: gemm[k] for k in timed + device}},
             "launches_mla_training": mla["training"]["band_gemm"],
             "launches_mla_serving": mla["serving"]["band_gemm"],
             "launches_mrope_training": mrope["training"]["band_gemm"],
             "launches_mrope_serving": mrope["serving"]["band_gemm"],
             "launches_encdec_training": encdec["training"]["band_gemm"],
             "launches_encdec_serving": encdec["serving"]["band_gemm"],
             "launches_hymba_training": hymba["training"]["band_gemm"],
             "launches_hymba_serving": hymba["serving"]["band_gemm"],
             "launches_multips_reduced":
                 multips_r["launches"]["band_gemm"],
             "launches_multips_training": multips["training"]["band_gemm"],
             "launches_batch": batch["band_gemm"],
             "launches_examples": ex["band_gemm"],
             "examples_max_rel_vs_plain":
                 examples["max_rel_vs_plain"]["band_gemm"],
             "batch_poison_escapes": batch["poison"],
             "mrope_training_step": {
                 "ms_of": "the launches of mrope_full's first training step "
                          "(qwen2-vl-72b, 3 layers, bf16)",
                 **mrope["set"]},
             "encdec_training_step": {
                 "ms_of": "the launches of encdec_full's first training "
                          "step (seamless-m4t-medium, 12 + 12 layers, bf16)",
                 **encdec["set"]},
             "hymba_training_step": {
                 "ms_of": "the launches of hymba_full's first training "
                          "step (hymba-1.5b, 32 layers, bf16)",
                 **hymba["set"]},
             "mla_training_step": {
                 "ms_of": "the launches of mla_full's first training step "
                          "(deepseek-v2-236b, 1 layer, bf16)",
                 **mla["sets"]["band_gemm_step"]},
             "f32_cells": {
                 "ms_of": "the f32 launches of each f32-policy cell's first "
                          "fleet step",
                 **{c: f32_set(c) for c in cells}}},
            {"name": "paged_decode", "route": "cuda",
             "source": "src/repro_torch/csrc/paged_decode.cu",
             "replaces": "src/repro/kernels/decode_attention.py:97",
             "redesigned": "splits over the card, a producer warp feeding "
                           "an mbarrier ring, each key scored once for all "
                           "G rows, pages of any size",
             "launches": launches["paged_decode"],
             "launches_serving_moe": moe["paged_decode"],
             "launches_serving_mrope": mrope["serving"]["paged_decode"],
             "launches_examples": ex["paged_decode"],
             "examples_max_rel_vs_plain":
                 examples["max_rel_vs_plain"]["paged_decode"],
             "launches_by_route": launches["paged_decode_by_route"],
             "ms_of": "one launch at the serving path's shape (4 requests "
                      "of 23 tokens, pages of 16, f32 pools)",
             "max_abs_err": paged["max_abs_err"],
             "ms": paged_main["kernel_ms"],
             "plain_ms": paged_main["plain_ms"],
             "bound_ms": paged_main["bound_ms"],
             "bound_by": paged_main["bound_by"], "library_ms": None,
             "device_ms": paged_main["device_ms"],
             "cache_32k_bf16": paged["timed"]["paged32k_bfloat16"],
             **{k_: v_ for k_, v_ in paged["timed"].items()
                if k_ not in ("main_path_float32", "paged32k_bfloat16")}},
            {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:64",
             "launches": train_launches["flash_attention"],
             "launches_serving": launches["flash_attention"],
             "ms_of": "one launch at the training step's shape (f32)",
             "redesigned": "f32 CUDA-core tiles, K/V staged once per kv "
                           "head; Dk != Dv up to 192 / 128",
             "max_abs_err": flash["max_abs_err"], "ms": flash["kernel_ms"],
             "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
             "bound_by": flash["bound_by"],
             "library_ms": flash["library_ms"],
             **{k: flash[k] for k in device},
             "launches_mla_training": mla["training"]["flash_attention"],
             "launches_mla_serving": mla["serving"]["flash_attention"],
             "launches_mrope_training": mrope["training"]["flash_attention"],
             "launches_mrope_serving": mrope["serving"]["flash_attention"],
             "launches_encdec_training":
                 encdec["training"]["flash_attention"],
             "launches_encdec_serving": encdec["serving"]["flash_attention"],
             "launches_hymba_training": hymba["training"]["flash_attention"],
             "launches_hymba_serving": hymba["serving"]["flash_attention"],
             "launches_multips_reduced":
                 multips_r["launches"]["flash_attention"],
             "launches_multips_training":
                 multips["training"]["flash_attention"],
             "launches_examples": ex["flash_attention"],
             "examples_max_rel_vs_plain":
                 examples["max_rel_vs_plain"]["flash_attention"],
             "launches_mesh_reduced":
                 mesh_r["launches"]["flash_attention"],
             "mesh_reduced_max_rel_vs_plain": mesh_r["b4_max_rel_err"],
             "launches_mesh_full": {k: v["launches"]["B4"]
                                    for k, v in mesh_f.items()},
             "mesh_full_signatures_max_rel_vs_plain": max(
                 v["signatures_checked"]["B4"]["max_rel_err"]
                 for v in mesh_f.values()),
             "hymba_prefix_window_shapes": {
                 "ms_of": "one launch with hymba-1.5b's 128 meta keys "
                          "always visible under a sliding window: at its "
                          "training shape with a window of 64, and at B "
                          "1, Sq 4096 with a window of 2048; library: "
                          "scaled_dot_product_attention with the mask",
                 **{k: flash["timed"][k] for k in (
                     "hymba_prefix_w64_float32", "hymba_prefix_w64_bfloat16",
                     "hymba_prefix_w2048_float32",
                     "hymba_prefix_w2048_bfloat16")}},
             "hymba_shape": {
                 "ms_of": "one launch at hymba-1.5b's training shape (B 8, "
                          "Sq 128 after 128 meta keys, Sk 256, q_offset "
                          "128, 25 heads over 5, D 64, causal); library: "
                          "scaled_dot_product_attention with the offset "
                          "mask",
                 "float32": flash["timed"]["hymba_train_float32"],
                 "bfloat16": flash["timed"]["hymba_train_bfloat16"]},
             "encdec_cross_shape": {
                 "ms_of": "one launch at seamless-m4t-medium's training "
                          "cross-attention (B 8, Sq 128, Sk 256, 16 heads "
                          "over 16, D 64, non-causal, bf16); library: "
                          "scaled_dot_product_attention",
                 **flash["timed"]["encdec_cross_bfloat16"]},
             "mrope_shape": {
                 "ms_of": "one launch at qwen2-vl-72b's training shape (B "
                          "8, S 128, 64 heads over 8, D 128, causal, "
                          "bf16); library: scaled_dot_product_attention",
                 **flash["timed"]["mrope_train_bfloat16"]},
             "mla_shape": {
                 "ms_of": "one launch at deepseek-v2-236b's training shape "
                          "(B 8, S 128, 128 heads over 128, Dk 192, Dv "
                          "128); library: scaled_dot_product_attention",
                 "float32": flash["timed"]["mla_train_float32"],
                 "bfloat16": flash["timed"]["mla_train_bfloat16"]}},
            {"name": "flash_decode", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/decode_attention.py:144",
             "redesigned": "a 4-stage cp.async K/V ring, each key scored "
                           "once for all G rows",
             "launches": launches["flash_decode"],
             "launches_mrope_serving": mrope["serving"]["flash_decode"],
             "launches_encdec_serving": encdec["serving"]["flash_decode"],
             "launches_hymba_serving": hymba["serving"]["flash_decode"],
             "launches_examples": ex["flash_decode"],
             "examples_max_rel_vs_plain":
                 examples["max_rel_vs_plain"]["flash_decode"],
             "launches_mesh_reduced": mesh_r["launches"]["flash_decode"],
             "mesh_reduced_max_rel_vs_plain": mesh_r["b5_max_rel_err"],
             "launches_mesh_full": {k: v["launches"]["B5"]
                                    for k, v in mesh_f.items()},
             "launches_by_route": launches["flash_decode_by_route"],
             "ms_of": "one launch at the serving path's shape (4 requests, "
                      "cache of 32, f32 pools)",
             "max_abs_err": decode["max_abs_err"],
             "ms": dec_serve["kernel_ms"], "plain_ms": dec_serve["plain_ms"],
             "bound_ms": dec_serve["bound_ms"],
             "bound_by": dec_serve["bound_by"],
             "library_ms": dec_serve["library_ms"],
             "device_ms": dec_serve["device_ms"],
             "library_device_ms": dec_serve["library_device_ms"],
             "cache_32k_bf16": dec_long,
             **{k_: v_ for k_, v_ in decode["timed"].items()
                if k_ not in ("serving_float32", "cache32k_bfloat16")}},
            {"name": "wkv6", "route": "cuda",
             "source": "src/repro_torch/csrc/wkv6.cu",
             "replaces": "src/repro/kernels/wkv6.py:66",
             "redesigned": "state in registers, 4 x 4 register tiles, "
                           "cp.async prefetch",
             "launches": rwkv["training"],
             "launches_serving": rwkv["serving"],
             "launches_examples": ex["wkv6"],
             "ms_of": "one launch at the RWKV training shape (B 8, S 128, "
                      "64 heads of 64, bf16 r/k/v)",
             "max_abs_err": wkv["max_abs_err"], "ms": wkv["kernel_ms"],
             "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
             "bound_by": wkv["bound_by"], "library_ms": wkv["library_ms"],
             "device_ms": wkv["device_ms"],
             "decode": wkv["timed"]["decode"],
             "prompt100": wkv["timed"]["prompt100"]},
            {"name": "block_gemm_batched", "route": "cuda",
             "source": "src/repro_torch/csrc/band_gemm.cu",
             "replaces": "src/repro/kernels/block_gemm.py:92",
             "redesigned": "bf16: wgmma/TMA; f32: wide and skinny "
                           "cp.async FMA tilings, f32 x bf16 entry",
             "launches": moe["training"],
             "launches_serving": moe["serving"],
             "launches_by_body": moe["bodies"],
             "launches_mla_training": mla["training"]["bgemm"],
             "launches_mla_serving": mla["serving"]["bgemm"],
             "launches_examples": ex["block_gemm_batched"],
             "launches_mesh_reduced":
                 mesh_r["launches"]["block_gemm_batched"],
             "mesh_reduced_max_rel_vs_plain": mesh_r["b2_max_rel_err"],
             "launches_mesh_full": {k: v["launches"]["B2"]
                                    for k, v in mesh_f.items()},
             "mesh_full_signatures_max_rel_vs_plain": max(
                 v["signatures_checked"]["B2"]["max_rel_err"]
                 for v in mesh_f.values()),
             "max_abs_err_mla": mla["max_abs_err"],
             "mla_training_step": {
                 "ms_of": "the launches of mla_full's first training step "
                          "(160 experts, 48 slots each, bf16)",
                 **mla["sets"]["bgemm_step"]},
             "ms_of": f"the {b2_train['launches']} launches of one "
                      "full-width granite-moe-1b-a400m training step (bf16)",
             **{k: b2_train[k] for k in timed + device},
             "max_abs_err_on_path": moe["max_abs_err"],
             "decode_step": {
                 "ms_of": f"the {b2_dec['launches']} launches of one "
                          "full-width decode step (4 slots), bf16",
                 **{k: b2_dec[k] for k in timed + device}},
             "decode_step_f32": {
                 "ms_of": f"the {b2_dec32['launches']} launches of one "
                          "full-width decode step as it runs them: f32 A, "
                          "bf16 B read as stored; library: torch.bmm in f32",
                 **{k: b2_dec32[k] for k in timed + device}},
             "f32_cell": {
                 "ms_of": "the launches of moe_reduced's first fleet step",
                 **f32_set("moe_reduced", "bgemm_step")}},
            {"name": "block_gemm", "route": "cuda",
             "source": "src/repro_torch/csrc/band_gemm.cu",
             "replaces": "src/repro/kernels/block_gemm.py:125",
             "launches": b3["launches"],
             "launches_by_body": b3["launches_by_body"],
             "launches_examples": ex["block_gemm"],
             "redesigned": "f32: wide cp.async FMA tiling, split-K",
             "ms_of": "one launch of ops.block_gemm at 512 x 512 x 512 f32 "
                      "(benchmarks/kernels_bench.py's shape); "
                      "launches_by_body counts it and one bf16 call",
             **{k: b3[k] for k in timed + device}},
            {"name": "freivalds", "route": "cuda",
             "source": "src/repro_torch/csrc/freivalds.cu",
             "replaces": None,
             "redesigned": "no Pallas kernel: the reference's XLA einsums "
                           "(src/repro/kernels/ops.py:169); one product and "
                           "one operand launch a bucket, signs hashed in "
                           "registers, fixed-order partial sums",
             # one a verified bucket of every path on the card, each
             # phase's count held to its buckets (residual_since)
             "launches": sum(RESIDUALS_BY_PHASE.values()),
             "launches_by_phase": dict(RESIDUALS_BY_PHASE),
             "checked_launches": fv["launches"],
             "signs_bit_equal": fv["signs_bit_equal"],
             "ms_of": "each GEMM's buckets, with the host's gaps hidden "
                      "(plain: by events)",
             "gemms": fv["gemms"]},
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
