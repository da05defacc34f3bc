"""Edge-device fleet sampling (§2.1, §5.1).

Compute capabilities follow the AI-Benchmark-style range (phones ~5-7
TFLOPS, laptops up to 27 TFLOPS); link speeds follow fixed-broadband /
cellular measurements (DL 10-100 MB/s, UL 5-10 MB/s, i.e. 2-10x asymmetry).
The paper's median device: 6 TFLOPS, 55 MB/s DL, 7.5 MB/s UL, 512 MB usable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np

from repro_torch.core.cost_model import Device
from repro_torch.core.seeding import as_rng

MEDIAN_DEVICE = dict(flops=6e12, dl_bw=55e6, ul_bw=7.5e6,
                     dl_lat=0.05, ul_lat=0.01, memory=512e6)


def median_fleet(n: int) -> List[Device]:
    return [Device(device_id=i, **MEDIAN_DEVICE) for i in range(n)]


def sample_fleet(n: int, rng: Union[np.random.Generator, int, None] = None,
                 phone_fraction: float = 0.6,
                 straggler_fraction: float = 0.0,
                 straggler_slowdown: float = 10.0) -> List[Device]:
    """Heterogeneous fleet: `phone_fraction` phone-class (5-7 TFLOPS, 512 MB),
    rest laptop-class (15-27 TFLOPS, 10 GB).  Links sampled uniformly within
    the measured ranges.  Stragglers are `straggler_slowdown`x slower in both
    compute and links (Fig. 6 setup).  `rng` may be a Generator or an int
    seed (see :func:`as_rng`)."""
    rng = as_rng(rng)
    devices = []
    n_straggler = int(round(straggler_fraction * n))
    for i in range(n):
        phone = rng.uniform() < phone_fraction
        flops = rng.uniform(5e12, 7e12) if phone else rng.uniform(15e12, 27e12)
        mem = 512e6 if phone else 10e9
        dl = rng.uniform(10e6, 100e6)
        ul = rng.uniform(5e6, 10e6)
        d = Device(flops=flops, dl_bw=dl, ul_bw=ul, dl_lat=0.05, ul_lat=0.01,
                   memory=mem, device_id=i)
        devices.append(d)
    for i in rng.choice(n, size=n_straggler, replace=False):
        d = devices[i]
        devices[i] = dataclasses.replace(
            d, flops=d.flops / straggler_slowdown,
            dl_bw=d.dl_bw / straggler_slowdown,
            ul_bw=d.ul_bw / straggler_slowdown)
    return devices


def fleet_stats(devices) -> dict:
    f = np.array([d.flops for d in devices])
    return {
        "n": len(devices),
        "total_flops": float(f.sum()),
        "mean_flops": float(f.mean()),
        "cv_flops": float(f.std() / f.mean()),
        "total_dl": float(sum(d.dl_bw for d in devices)),
        "total_ul": float(sum(d.ul_bw for d in devices)),
    }


def mtbf_minutes(n_devices: int, hourly_failure_rate: float = 0.01) -> float:
    """System-level MTBF under per-device interruption rate (§2.3):
    ~47 min at 128 devices, ~12 min at 512, <6 min at 1024."""
    return 60.0 / (n_devices * hourly_failure_rate)
