"""One run of one cell: set-up, the measured window, an optional traced
stretch, and the check against the plain reference.

Set-up builds one training session of the port (``repro_torch``) with
its model and optimizer state from the seed, drives it through the
check's first steps and then warm-up steps until a step solves no plan
cold, and hands that same session to the window.  After the window, and
after the peak memory has been read, the program's state is freed and
the reference runs the same first steps from the same weights and
batches."""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
import warnings
from typing import Dict, List, Optional

import torch

from cbench import check, inputs, tracing, yardstick
from cbench.spec import Cell, family, reader
from cbench.window import Window, run_window
from reference.common import (diff_norms, get_path, leaf_norms, leaf_paths,
                              nest, train_readings)


class RunFailed(RuntimeError):
    """The run cannot give a result (a cold plan solve in the window)."""


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The port's training session of a cell, built from the seed."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.api import Fleet, TorchCleaveRuntime
        from repro_torch.configs.base import get_config
        from repro_torch.optim import adam

        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.family = family(cfg)
        self.layout = self.family.layout(cfg)
        port = dict(cfg["port"])
        arch = get_config(port.pop("arch"))
        self.arch = dataclasses.replace(arch, **port)
        self.batch, self.seq = tr["batch"], tr["seq"]
        self.tokens = inputs.Tokens(cfg["vocab_size"], self.batch, self.seq,
                                    seed, **tr["data"])
        n_check = tr["check_steps"]
        self.check_batches = self.tokens.device(range(n_check), device)
        self.pool = self.tokens.device(
            range(n_check, n_check + tr["pool"]), device)
        self.weights = inputs.make_weights(self.layout, seed, device)
        self.params = nest(list(self.weights), list(self.weights.values()))
        self.opt_cfg = adam.AdamConfig(**tr["optimizer"])
        self.opt = adam.init(self.params, self.opt_cfg)
        fl = tr["fleet"]
        self.rt = TorchCleaveRuntime(
            arch=self.arch, device=device,
            fleet=Fleet.sample(fl["devices"], seed=fl["seed"],
                               phone_fraction=fl["phone_fraction"]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # PS-local GEMMs
            self.sess = self.rt.train_session(
                self.opt_cfg, backend="torch", verify=True,
                dispatch=tr["dispatch"], **tr["chunks"])
        self.churn = tr.get("churn")

    def step(self, batch):
        """One step of the port, as the window drives it."""
        fail, back = (), []
        if self.churn:
            fail = tuple(self.churn["fail_ids"])
            back = [d for d in self.rt.fleet.devices if d.device_id in fail]
        self.params, self.opt, met = self.sess.step(
            self.params, self.opt, batch, donate=True, fail_ids=fail,
            fail_at_gemm=self.churn["fail_at_gemm"] if fail else 0)
        if self.churn and self.churn.get("rejoin"):
            for dev in back:
                self.rt.on_join(dev, keep_id=True)
        return met["fleet"]

    def check_steps(self) -> Dict:
        """The check's first steps, on batches whose rows all differ:
        each step's loss, each leaf's norm of the first gradient (from
        the first moment after one step) and of the change over the
        steps."""
        paths = leaf_paths(self.params)
        b1 = self.opt_cfg.b1
        losses, verified, grad1, norms = [], [], None, []
        for i, batch in enumerate(self.check_batches):
            rep = self.step(batch)
            losses.append(rep.loss)
            norms.append(rep.grad_norm)
            verified.append(rep.verified)
            if i == 0:
                mu = [get_path(self.opt.mu, p) for p in paths]
                grad1 = [n / (1 - b1) for n in leaf_norms(mu)]
        before = inputs.make_weights(self.layout, self.seed, self.device)
        change = diff_norms([get_path(self.params, p) for p in paths],
                            [before[p] for p in paths])
        del before
        return {"paths": ["/".join(p) for p in paths], "losses": losses,
                "grad1": grad1, "change": change, "grad_norms": norms,
                "verified": verified,
                "last": rep}

    def warm(self, last) -> int:
        """Warm-up steps until a step solves no plan cold and finds every
        plan cached."""
        n = 0
        while last.n_cold_plan_solves or last.plan_cache_hit_rate < 1.0:
            if n >= self.cell.traffic["max_warmup_steps"]:
                raise RunFailed(f"plans still cold after {n} warm-up steps")
            last = self.step(self.pool[n % len(self.pool)])
            n += 1
        return n

    def close(self):
        for name in ("params", "opt", "weights", "sess", "rt", "pool"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(cell: Cell, seed: int, device, batches,
                       precision: str = "bf16",
                       rows: slice = slice(None)) -> Dict:
    fam = family(cell.config)
    layout = fam.layout(cell.config)
    return train_readings(
        fam, cell.config,
        lambda: inputs.make_weights(layout, seed, device),
        batches, cell.traffic["optimizer"], precision, rows)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader may read."""
    cell: Cell
    flops_per_step: float
    window: Window
    reports: list            # the window's FleetStepReports
    trace: Optional[tracing.Trace]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, log=print) -> Dict:
    """One run; returns the result line's fields (``checks`` last)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = cell.traffic

    def phase(what):
        log(f"[{time.perf_counter() - started:8.2f} s] {what}")

    s = Session(cell, seed, device)
    phase("session built")
    prog = s.check_steps()
    phase(f"check steps, losses {prog['losses']}")
    n_warm = s.warm(prog.pop("last"))
    phase(f"{n_warm} warm-up steps")
    reports: List = []
    batch_tokens = s.batch * s.seq

    def window_step(i):
        reports.append(s.step(s.pool[(n_warm + i) % len(s.pool)]))

    win = run_window(window_step, seconds, batch_tokens,
                     lambda: _sync(device))
    setup_s = win.started - started
    phase(f"window: {win.steps} steps in {win.seconds:.3f} s")
    if any(r.n_cold_plan_solves or r.plan_cache_hit_rate < 1.0
           for r in reports):
        raise RunFailed("a plan was solved cold inside the window")
    traced = None
    if trace:
        n = tr["trace_steps"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_reps = []
            for i in range(n):
                with record_function(tracing.STEP_RANGE):
                    traced_reps.append(s.step(s.pool[i % len(s.pool)]))
            _sync(device)
        phase(f"{n} traced steps")
        traced = tracing.read(prof, n, [r for rep in traced_reps
                                        for r in rep.records])
        del prof
        phase("trace read")
        reports_verified = [r.verified for r in traced_reps]
    else:
        reports_verified = []
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    verified = prog.pop("verified") + [r.verified for r in reports] \
        + reports_verified
    for r in reports:
        r.records = []
    s.close()
    phase(f"program freed, peak {peak / 1e9:.3f} GB")
    ref = reference_readings(cell, seed, device, s.check_batches)
    phase("reference")
    numbers = check.readings(prog, ref)
    widest = check.worst(prog["grad1"], ref["grad1"], ref["paths"])
    log(f"widest first-gradient gaps {widest}")
    numbers["unverified_steps"] = float(sum(not v for v in verified))
    limits = dict(cell.limits, unverified_steps=0.0)
    correct = check.verdict(numbers, limits)
    log(f"losses program {prog['losses']} reference {ref['losses']}")

    fam = family(cell.config)
    flops = yardstick.step_flops(fam, cell.config, s.batch, s.seq)
    if trace:
        ctx = Reading(cell, flops, win, reports, traced)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"train_tokens_per_s": win.tokens_per_s,
                  "peak_device_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": correct, "attempted": win.steps,
           "failed": sum(not r.verified for r in reports),
           "metrics": metrics,
           "window": {"steps": win.steps, "seconds": win.seconds,
                      "warmup_steps": n_warm,
                      "step_s_median": statistics.median(
                          r.wall_time for r in reports),
                      "fleet_exec_s_mean": statistics.mean(
                          r.fleet_exec_time for r in reports)},
           "memory_peak_bytes": peak}
    if traced is not None:
        out["traced"] = traced
    out["checks"] = check.report(numbers, limits)
    return out
