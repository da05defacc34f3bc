"""Fleet-backed decode serving session: continuous batching over a paged KV
cache on the device, with every projection GEMM executed on the device
fleet (port of ``src/repro/serving/decode_session.py``).

Each :meth:`ServeSession.step` decodes one token for every occupied slot:
admission (arrived requests take free slots, reserve their page budget,
and prefill ``prompt[:-1]`` monolithically on the PS), a gather of the
pools into contiguous views, ``models.model.decode_step`` with the
``pdot`` hook open -- the batch's q/k/v/out projections, SwiGLU and
lm_head each run as one fleet GEMM, through the band GEMM kernel for
``backend="torch"`` on the card -- then greedy sampling, the new K/V
scattered back into pages, and retirement.  A virtual clock advances by
the engine-priced makespan of each step's plans beside the measured wall
time.  ``check_paged_read=True`` cross-checks, every step, the paged
decode kernel reading the pools in place against dense attention over the
gathered view.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.train_loop.fleet_gemm import FleetGemmSession, GemmRecord


@dataclass
class ServeStepReport:
    """One continuous-batching decode step."""
    step: int
    n_active: int
    n_admitted: int
    n_retired: int
    wall_time: float             # measured host wall (prefill + decode)
    priced_makespan: float       # engine.price_plan sum over the step's GEMMs
    n_gemms: int
    n_tasks: int
    n_recovered: int
    verified: bool
    plan_cache_hit_rate: float
    failed_ids: Tuple[int, ...] = ()
    records: List[GemmRecord] = field(default_factory=list, repr=False)


@dataclass
class ServeReport:
    """Aggregate latency report over the finished requests of a session."""
    n_requests: int
    n_tokens: int
    n_steps: int
    wall_time: float             # total measured step wall
    virtual_time: float          # total engine-priced fleet time
    tokens_per_sec: float        # measured
    tokens_per_sec_priced: float
    token_lat_p50: float
    token_lat_p99: float
    token_lat_p50_priced: float
    token_lat_p99_priced: float
    e2e_p50: float
    e2e_p99: float
    e2e_p50_priced: float
    e2e_p99_priced: float
    plan_cache_hit_rate: float
    n_recovered: int
    failed_ids: Tuple[int, ...] = ()
    cache: Optional[object] = None        # kv_cache.CacheStats

    def log_line(self) -> str:
        s = (f"serve: {self.n_requests} reqs {self.n_tokens} toks in "
             f"{self.n_steps} steps | {self.tokens_per_sec:.1f} tok/s "
             f"measured ({self.tokens_per_sec_priced:.1f} priced) | "
             f"token p50/p99 {self.token_lat_p50 * 1e3:.1f}/"
             f"{self.token_lat_p99 * 1e3:.1f} ms | "
             f"cache {self.plan_cache_hit_rate:.0%}")
        if self.failed_ids:
            s += (f" | failed {list(self.failed_ids)} recovered "
                  f"{self.n_recovered} tasks")
        return s


class ServeSession:
    """Continuous-batching fleet decode (module docstring).

    Built via :meth:`TorchCleaveRuntime.serve_session`; runs on the
    runtime's device.  ``params=None`` draws random params from ``seed``.
    ``last_logits`` holds the most recent step's (slots, 1, V) logits."""

    def __init__(self, runtime, params=None, *, cfg=None, slots: int = 8,
                 page_size: int = 16, max_len: int = 64,
                 kv_int8: bool = False, backend: str = "torch",
                 kernel: str = "auto", dtype_policy=None,
                 verify: bool = True, check_paged_read: bool = False,
                 n_pages: Optional[int] = None, seed: int = 0,
                 dispatch: str = "level"):
        self.rt = runtime
        self.device = runtime.device
        self.cfg = cfg if cfg is not None else runtime.cfg
        self.slots = int(slots)
        self.page = int(page_size)
        self.cache_len = self.page * math.ceil(max_len / self.page)
        pages_per_req = self.cache_len // self.page
        # raises the reference's ValueError for recurrent (RWKV, SSM,
        # hybrid) and enc-dec families, whose states are not paged, before
        # any params are drawn
        self.kv = PagedKVCache(
            self.cfg, page_size=self.page, kv_int8=kv_int8,
            n_pages=(n_pages if n_pages is not None
                     else self.slots * pages_per_req),
            device=self.device)
        if params is None:
            from repro_torch.models import model as M
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(self.cfg, gen)
        self.params = params
        self.batcher = ContinuousBatcher(self.slots, self.kv)
        self.dispatch = dispatch
        self.gemms = FleetGemmSession(runtime, backend=backend,
                                      kernel=kernel,
                                      dtype_policy=dtype_policy,
                                      verify=verify, dispatch=dispatch)
        self.kv_int8 = bool(kv_int8)
        self.check_paged_read = bool(check_paged_read)
        self.paged_read_checks = 0
        self.clock = 0.0           # virtual (engine-priced) time
        self.wall = 0.0            # accumulated measured step wall
        self.step_index = 0
        self.step_reports: List[ServeStepReport] = []
        self.last_logits: Optional[torch.Tensor] = None
        self._check_q = None

    # -------------------------------------------------------------- intake --

    def submit(self, prompt, max_new: int, arrival: float = 0.0) -> Request:
        """Queue one request (prompt token ids + generation budget)."""
        req = self.batcher.submit(np.asarray(prompt), max_new,
                                  arrival=arrival)
        if req.budget > self.cache_len:
            raise ValueError(
                f"request budget {req.budget} exceeds the session max_len "
                f"capacity {self.cache_len}")
        return req

    def _ingest(self, req: Request) -> None:
        """Prefill ``prompt[:-1]`` monolithically on the PS and write its
        K/V into the request's pages; the first decode step feeds
        ``prompt[-1]``."""
        from repro_torch.models import model as M
        P = req.prompt_len - 1
        if P <= 0:
            return
        toks = torch.as_tensor(np.asarray(req.prompt[None, :P], np.int64),
                               device=self.device)
        _, cache = M.prefill(self.cfg, self.params, {"tokens": toks})
        vals = {nm: cache[nm][:, 0] for nm in self.kv.pools if nm in cache}
        self.kv.write_prompt(req.rid, vals)

    # ---------------------------------------------------------------- step --

    def step(self, fail_ids: Sequence[int] = (),
             fail_at_gemm: int = 0) -> Optional[ServeStepReport]:
        """One continuous-batching decode step (admit → decode one token per
        occupied slot through the fleet → scatter KV → retire).  Returns
        ``None`` when there is nothing to decode and nothing queued."""
        from repro_torch.models import model as M
        t0 = time.perf_counter()
        if not self.batcher.active:
            nxt = self.batcher.next_arrival()
            if nxt is None:
                return None
            self.clock = max(self.clock, nxt)
        admitted = self.batcher.admit(self.clock, self.wall)
        for req in admitted:
            self._ingest(req)
        active = [(b, r) for b, r in enumerate(self.batcher.slots)
                  if r is not None]
        if not active:
            return None

        B = self.slots
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        rids: List[Optional[int]] = [None] * B
        for b, r in active:
            tokens[b, 0] = r.tokens[-1] if r.tokens else int(r.prompt[-1])
            pos[b] = r.next_pos
            rids[b] = r.rid
        cache = self.kv.gather(rids, self.cache_len)
        cache["pos"] = torch.as_tensor(pos, device=self.device)

        with self.gemms.open() as fleet:
            if fail_ids:
                fleet.arm_failure(fail_ids, at_gemm=fail_at_gemm)
            logits, new_cache = M.decode_step(
                self.cfg, self.params, cache,
                torch.as_tensor(tokens, device=self.device))
        records, _ = self.gemms.drain()
        fired = tuple(sorted({int(i) for r in records
                              for i in r.failed_ids}))
        if fail_ids and not fired:
            raise RuntimeError(
                f"fail_at_gemm={fail_at_gemm} exceeds the step's "
                f"{len(records)} fleet GEMMs: the failure never fired")

        self.last_logits = logits
        next_tok = torch.argmax(logits[:, 0, :self.cfg.vocab_size],
                                dim=-1).cpu().numpy()
        act = np.asarray([b for b, _ in active])
        act_pos = pos[act]
        bidx = torch.as_tensor(act, device=self.device)
        sidx = torch.as_tensor(act_pos.astype(np.int64), device=self.device)
        upd = {nm: new_cache[nm][:, bidx, sidx] for nm in self.kv.pools}
        self.kv.write_tokens([rids[b] for b in act], act_pos, upd)
        if self.check_paged_read:
            self._check_paged_read(rids)

        priced = self.gemms.price_step(records)
        self.clock += priced
        wall = time.perf_counter() - t0
        self.wall += wall
        for b, r in active:
            r.tokens.append(int(next_tok[b]))
            r.token_times.append(self.clock)
            r.token_walls.append(self.wall)
        retired = self.batcher.retire(self.clock, self.wall)

        report = ServeStepReport(
            step=self.step_index, n_active=len(active),
            n_admitted=len(admitted), n_retired=len(retired),
            wall_time=wall, priced_makespan=priced,
            n_gemms=len(records),
            n_tasks=sum(r.n_tasks for r in records),
            n_recovered=sum(r.n_recovered for r in records),
            verified=all(r.verified for r in records),
            plan_cache_hit_rate=(sum(r.plan_cached for r in records)
                                 / max(len(records), 1)),
            failed_ids=fired, records=records)
        self.step_reports.append(report)
        self.rt.history.append({
            "event": "serve_step", "step": self.step_index,
            "n_active": report.n_active, "n_gemms": report.n_gemms,
            "n_recovered": report.n_recovered,
            "verified": report.verified,
            "priced_makespan": report.priced_makespan,
            "failed_ids": list(fired)})
        self.step_index += 1
        return report

    def run(self, max_steps: int = 10_000,
            fail_ids: Sequence[int] = (),
            fail_at_step: Optional[int] = None) -> "ServeReport":
        """Drive :meth:`step` until every submitted request finishes (or
        ``max_steps``), failing ``fail_ids`` at step ``fail_at_step``."""
        for i in range(max_steps):
            inject = (fail_ids if fail_at_step is not None
                      and i == fail_at_step else ())
            if self.step(fail_ids=inject) is None:
                break
        else:
            if not self.batcher.idle:
                raise RuntimeError(
                    f"serve run did not drain in {max_steps} steps "
                    f"({self.batcher.n_pending} pending, "
                    f"{len(self.batcher.active)} active)")
        return self.report()

    # --------------------------------------------------------------- checks --

    def _check_paged_read(self, rids: List[Optional[int]]) -> None:
        """The paged decode kernel reading layer 0's pools in place must
        match plain dense attention over the gathered contiguous view
        (2e-4, the reference's tolerance: f32 sums in another order).
        The plain version is called by name: on the card
        ``decode_attention`` is the flash-decode kernel, and this check
        holds one kernel against plain PyTorch, not against another
        kernel.  MLA returns at once, as in the reference: the paged
        kernel reads K/V pools (the GQA layout), not latent ones."""
        from repro_torch.kernels import ops
        from repro_torch.models.attention import decode_attention_plain
        if self.cfg.mla:
            return
        pt, ln = self.kv.page_table_array(rids)
        if not ln.any():
            return
        kp, vp = self.kv.pools["k"][0], self.kv.pools["v"][0]
        if self.kv_int8:
            kp = kp.float() * self.kv.pools["k_scale"][0][..., None].float()
            vp = vp.float() * self.kv.pools["v_scale"][0][..., None].float()
        B, H, D = len(rids), self.cfg.n_heads, self.cfg.head_dim
        if self._check_q is None:
            rng = np.random.default_rng(0)
            self._check_q = torch.as_tensor(
                rng.standard_normal((B, 1, H, D)).astype(np.float32),
                device=self.device)
        dev = self.device
        got = ops.gqa_flash_decode_paged(
            self._check_q, kp, vp, torch.as_tensor(pt, device=dev),
            torch.as_tensor(ln, device=dev))
        views = self.kv.gather(rids, self.cache_len)
        k, v = views["k"][0], views["v"][0]
        if self.kv_int8:
            k = k.float() * views["k_scale"][0][..., None].float()
            v = v.float() * views["v_scale"][0][..., None].float()
        lnt = torch.as_tensor(ln, device=dev)
        valid = torch.arange(self.cache_len, device=dev)[None, :] \
            < lnt[:, None]
        want = decode_attention_plain(self._check_q, k, v, valid)
        live = lnt > 0       # rows of length 0 are fully masked in the oracle
        np.testing.assert_allclose(got[live].float().cpu().numpy(),
                                   want[live].float().cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)
        self.paged_read_checks += 1

    # --------------------------------------------------------------- report --

    def report(self) -> ServeReport:
        """Latency aggregate over the finished requests: measured wall and
        engine-priced virtual clock, side by side."""
        fin = self.batcher.finished
        tok_lat_m: List[float] = []
        tok_lat_v: List[float] = []
        e2e_m: List[float] = []
        e2e_v: List[float] = []
        n_tokens = 0
        for r in fin:
            n_tokens += len(r.tokens)
            # the virtual first-token latency baselines at arrival, the
            # wall clock at admission (arrivals are virtual-only)
            prev_w, prev_v = r.admit_wall, r.arrival
            for tw, tv in zip(r.token_walls, r.token_times):
                tok_lat_m.append(tw - prev_w)
                tok_lat_v.append(tv - prev_v)
                prev_w, prev_v = tw, tv
            e2e_m.append(r.finish_wall - r.admit_wall)
            e2e_v.append(r.finish_time - r.arrival)
        for r in self.batcher.active:       # in-flight tokens still count
            n_tokens += len(r.tokens)

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        recs = [rec for rep in self.step_reports for rec in rep.records]
        failed = tuple(sorted({int(i) for rep in self.step_reports
                               for i in rep.failed_ids}))
        return ServeReport(
            n_requests=len(fin), n_tokens=n_tokens,
            n_steps=self.step_index,
            wall_time=self.wall, virtual_time=self.clock,
            tokens_per_sec=n_tokens / max(self.wall, 1e-12),
            tokens_per_sec_priced=n_tokens / max(self.clock, 1e-12),
            token_lat_p50=pct(tok_lat_m, 50),
            token_lat_p99=pct(tok_lat_m, 99),
            token_lat_p50_priced=pct(tok_lat_v, 50),
            token_lat_p99_priced=pct(tok_lat_v, 99),
            e2e_p50=pct(e2e_m, 50), e2e_p99=pct(e2e_m, 99),
            e2e_p50_priced=pct(e2e_v, 50), e2e_p99_priced=pct(e2e_v, 99),
            plan_cache_hit_rate=(sum(r.plan_cached for r in recs)
                                 / max(len(recs), 1)),
            n_recovered=sum(r.n_recovered for r in recs),
            failed_ids=failed, cache=self.kv.stats())
