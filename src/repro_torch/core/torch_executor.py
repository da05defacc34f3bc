"""PyTorch fleet executor: runs a CLEAVE plan's assignment rectangles
through the band GEMM kernel (port of ``src/repro/core/jax_executor.py``).

Rectangles sharing a row range form a band; bands are bucketed by padded
height and every bucket runs as ONE band GEMM launch against the shared B
(``kernels.ops.plan_gemm_buckets``), with per-rectangle Freivalds residuals
computed on the device beside it.  Failure, corruption and churn recovery
follow the numpy executor exactly: same task order
(``executor.build_task_list``), same ``churn.recover`` patches, same PS
re-dispatch on a failed check.

Operands, padded copies and the output stay on the device.  Only the
per-rectangle residual scalars come to the host for the tolerance test,
and only flagged blocks go to the host ``verify.freivalds`` oracle.

Each phase runs in a span (``core.spans``): ``fleet.plan`` (the task
list), ``fleet.stage``, ``fleet.launch`` and ``fleet.readback`` (in
``ops.plan_gemm_buckets``), ``fleet.scatter``, ``fleet.sync`` and
``fleet.verify`` (its child ``fleet.oracle``); the report carries their
self times and the counters ``fleet.flagged`` and ``fleet.redispatched``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import spans
from repro_torch.core.executor import ExecutionReport, build_task_list
from repro_torch.core.seeding import as_rng
from repro_torch.core.verify import freivalds


@dataclass(frozen=True)
class DtypePolicy:
    """How the device fleet computes one sub-GEMM tile: ``compute_dtype``
    is the kernel input type, accumulation is always float32.  The
    per-block Freivalds tolerance is ``c * eps * sqrt(n / area)`` relative
    to the |r|·|C|·|s| scale (see the reference's ``DtypePolicy``)."""
    name: str
    compute_dtype: str
    eps: float
    freivalds_c: float

    def freivalds_rtol(self, n: int, area: int) -> float:
        return self.freivalds_c * self.eps * float(
            np.sqrt(max(n, 1) / max(area, 1)))


POLICIES = {
    # IEEE f32 compute / f32 accumulate (never TF32): the parity policy
    "f32": DtypePolicy(name="f32", compute_dtype="float32",
                       eps=1.2e-7, freivalds_c=16.0),
    # bf16 compute / f32 accumulate: the default on the card
    "bf16": DtypePolicy(name="bf16", compute_dtype="bfloat16",
                        eps=7.8e-3, freivalds_c=32.0),
}


def default_policy(device: Union[str, torch.device] = "cuda") -> DtypePolicy:
    return POLICIES["bf16" if torch.device(device).type == "cuda"
                    else "f32"]


def get_policy(policy: Union[str, DtypePolicy, None],
               device: Union[str, torch.device] = "cuda") -> DtypePolicy:
    if policy is None:
        return default_policy(device)
    if isinstance(policy, DtypePolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown dtype policy {policy!r}; "
                         f"known: {sorted(POLICIES)} or a DtypePolicy")
    return POLICIES[policy]


@dataclass
class TorchExecutionReport(ExecutionReport):
    """ExecutionReport plus the torch backend's host-clock accounting.
    ``output`` is a float32 tensor on the executing device."""
    backend: str = "torch"
    kernel: str = "cuda"           # 'cuda' | 'torch' (resolved)
    policy: str = "f32"
    exec_time: float = 0.0         # kernel + gather/scatter wall-clock
    verify_time: float = 0.0       # deferred Freivalds finalize wall-clock
    verify_seed: Optional[int] = None   # the probes' seed (ops.rademacher)
    # self seconds by span and counts by counter (core.spans), the
    # deferred finalize's included once it has run
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)


def _as_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _redispatch(Ab: torch.Tensor, Bb: torch.Tensor,
                pol: DtypePolicy) -> torch.Tensor:
    """Clean recompute of one tile under the policy dtype (the PS
    re-dispatch after a failed Freivalds check): operands rounded to the
    compute dtype, product and sum in f32."""
    cd = torch.bfloat16 if pol.compute_dtype == "bfloat16" else torch.float32
    return torch.matmul(Ab.to(cd).float(), Bb.to(cd).float())


def _check_partition(rects, m: int, q: int) -> None:
    """The rectangles tile the (m, q) output exactly: each inside it, no
    two overlapping, areas summing to m·q -- the verdict a dense (m, q)
    mask gives, at the cost of the rectangle count rather than of the
    output (an LM-head weight gradient, 4096 x 128256, would need a 525 MB
    host mask per GEMM).  Raises AssertionError otherwise."""
    r = np.asarray(rects, np.int64).reshape(-1, 4)
    r = r[(r[:, 1] > r[:, 0]) & (r[:, 3] > r[:, 2])]
    r0, r1, c0, c1 = r.T
    if not ((r0 >= 0) & (r1 <= m) & (c0 >= 0) & (c1 <= q)).all():
        raise AssertionError("coverage violated: a rectangle leaves the "
                             "output")
    overlap = (np.minimum(r1[:, None], r1[None]) > np.maximum(r0[:, None],
                                                             r0[None])) \
        & (np.minimum(c1[:, None], c1[None]) > np.maximum(c0[:, None],
                                                          c0[None]))
    np.fill_diagonal(overlap, False)
    if overlap.any():
        raise AssertionError("overlapping assignment")
    if int(((r1 - r0) * (c1 - c0)).sum()) != m * q:
        raise AssertionError("coverage violated: the rectangles leave a "
                             "hole")


def execute_plan_torch_deferred(
        gemm: cm.GEMM, plan: cm.Plan, A, B, devices: cm.Fleetlike,
        fail_ids: Sequence[int] = (),
        corrupt_ids: Sequence[int] = (),
        rng: Union[np.random.Generator, int, None] = None,
        verify: bool = True,
        policy: Union[str, DtypePolicy, None] = None,
        kernel: str = "auto",
        block: int = 128,
        pad_cache=None,
        device: Union[str, torch.device, None] = None
        ) -> Tuple[TorchExecutionReport, Callable[[], List[tuple]]]:
    """Split-phase :func:`execute_plan_torch`: the compute phase runs the
    bucket launches (with their device-side residuals) and scatters the
    blocks into a device-resident C; ``finalize`` reduces the residuals
    against the policy tolerance, confirms flagged blocks with the host
    oracle, and re-dispatches genuine corruption, updating
    ``report.verified``/``report.verify_time`` and returning the corrected
    rects.  Semantics mirror the reference's ``execute_plan_jax_deferred``.

    ``A``/``B`` are numpy arrays or tensors; ``device`` defaults to the
    tensors' device (else the card)."""
    from repro_torch.kernels import ops

    with spans.collect() as tally:
        with spans.span("fleet.plan"):
            dev = ops._device_of(A, B, device)
            pol = get_policy(policy, dev)
            kernel = ops.resolve_plan_kernel(kernel, dev)
            rng = as_rng(rng)
            m, q = gemm.m, gemm.q
            assert tuple(A.shape) == (m, gemm.n) \
                and tuple(B.shape) == (gemm.n, q)
            corrupt = set(corrupt_ids)
            tasks, recovery = build_task_list(gemm, plan, devices, fail_ids)
            n_rec = sum(1 for t in tasks if t.is_recovery)

            t0 = time.perf_counter()
            rects = [(t.r0, t.r1, t.c0, t.c1) for t in tasks]
            corrupt_mask = np.fromiter((t.device_id in corrupt for t in tasks),
                                       np.float32, count=len(tasks))
            seed = int(rng.integers(0, 2 ** 31 - 1)) if verify else None
        runs = ops.plan_gemm_buckets(A, B, rects, block=block, kernel=kernel,
                                     compute_dtype=pol.compute_dtype,
                                     verify_seed=seed, corrupt=corrupt_mask,
                                     pad_cache=pad_cache, device=dev)

        with spans.span("fleet.scatter"):
            C = torch.zeros((m, q), dtype=torch.float32, device=dev)
            run_dims = []
            written = []             # (r0, r1, c0, c1) of every write into C
            for run in runs:
                hs = run.band_hs.astype(np.int64)[run.bidx]
                ws = (run.c1s - run.c0s).astype(np.int64)
                run_dims.append((hs, ws))
                # each band bulk-writes the contiguous runs of its rects'
                # column union (one slice write per band for a grid
                # partition)
                Gb = len(run.band_r0s)
                cover = np.zeros((Gb, q + 1), np.int32)
                np.add.at(cover, (run.bidx, run.c0s), 1)
                np.add.at(cover, (run.bidx, run.c1s), -1)
                cover = np.cumsum(cover[:, :q], axis=1) > 0
                for b in range(Gb):
                    r0, h = int(run.band_r0s[b]), int(run.band_hs[b])
                    edges = np.flatnonzero(np.diff(cover[b].astype(np.int8)))
                    bounds = np.concatenate(
                        ([0] if cover[b, 0] else [], edges + 1,
                         [q] if cover[b, -1] else [])).astype(np.int64)
                    for s0, s1 in bounds.reshape(-1, 2):
                        C[r0:r0 + h, s0:s1] = run.out[b, :h, s0:s1]
                        written.append((r0, r0 + h, int(s0), int(s1)))
                if not verify:
                    # unchecked poisoning lands in the output, same form as
                    # the numpy executor
                    for g in np.nonzero(corrupt_mask[run.idx])[0]:
                        r0, c0 = rects[run.idx[g]][0], rects[run.idx[g]][2]
                        C[r0, c0] += 1.0 + C[r0, c0].abs()
        with spans.span("fleet.sync"):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        exec_time = time.perf_counter() - t0

        with spans.span("fleet.scatter"):
            # the plan tiles the output, and so do the writes actually made
            _check_partition(rects, m, q)
            _check_partition(written, m, q)
            report = TorchExecutionReport(
                output=C, verified=True, n_tasks=len(tasks),
                n_recovered=n_rec, recovery=recovery, backend="torch",
                kernel=kernel, policy=pol.name, exec_time=exec_time,
                verify_seed=seed, spans=tally.spans,
                counters=tally.counters)

    def finalize() -> List[tuple]:
        corrected: List[tuple] = []
        if not verify:
            return corrected
        t1 = time.perf_counter()
        with spans.collect() as vtally, spans.span("fleet.verify"):
            A_d, B_d = _as_device(A, dev), _as_device(B, dev)
            for run, (hs, ws) in zip(runs, run_dims):
                rtols = pol.freivalds_c * pol.eps * np.sqrt(
                    max(gemm.n, 1) / np.maximum(hs * ws, 1))
                ok = np.all(
                    np.abs(run.lhs - run.rhs)
                    <= rtols[:, None] * np.abs(run.rhs)
                    + (rtols * (run.scale + 1e-30))[:, None], axis=1)
                for g in np.nonzero(~ok)[0]:
                    # flagged on the device: confirm with the host oracle,
                    # then re-dispatch genuine corruption to a clean device
                    spans.count("fleet.flagged")
                    i = run.idx[g]
                    r0, r1, c0, c1 = rects[i]
                    with spans.span("fleet.oracle"):
                        if freivalds(_host(A_d[r0:r1]), _host(B_d[:, c0:c1]),
                                     _host(run.block(g)), rng,
                                     rtol=float(rtols[g])):
                            continue
                        report.verified = False
                        C[r0:r1, c0:c1] = _redispatch(A_d[r0:r1],
                                                      B_d[:, c0:c1], pol)
                    spans.count("fleet.redispatched")
                    corrected.append((r0, r1, c0, c1))
        report.verify_time += time.perf_counter() - t1
        spans.fold(report.spans, report.counters, vtally)
        return corrected

    return report, finalize


def execute_plan_torch(gemm: cm.GEMM, plan: cm.Plan, A, B,
                       devices: cm.Fleetlike,
                       fail_ids: Sequence[int] = (),
                       corrupt_ids: Sequence[int] = (),
                       rng: Union[np.random.Generator, int, None] = None,
                       verify: bool = True,
                       policy: Union[str, DtypePolicy, None] = None,
                       kernel: str = "auto",
                       block: int = 128,
                       pad_cache=None,
                       device: Union[str, torch.device, None] = None
                       ) -> TorchExecutionReport:
    """Execute every assignment rectangle on the torch backend, verifying
    inline (compute phase + immediate finalize)."""
    report, finalize = execute_plan_torch_deferred(
        gemm, plan, A, B, devices, fail_ids=fail_ids,
        corrupt_ids=corrupt_ids, rng=rng, verify=verify, policy=policy,
        kernel=kernel, block=block, pad_cache=pad_cache, device=device)
    finalize()
    report.exec_time += report.verify_time
    return report
