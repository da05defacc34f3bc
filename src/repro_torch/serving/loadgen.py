"""Request-level load generator: thousands of Poisson-arrival decode
streams driven through a :class:`~repro_torch.serving.ServeSession`.

Arrivals are exponential inter-arrival times on the session's **virtual
clock** (the engine-priced fleet time), so the offered load is measured in
the modeled system's own seconds: ``rate`` is requests per priced second.
Prompts are seeded-random token ids; generation is greedy.  The run drives
``session.step()`` until every stream finishes — continuous batching keeps
the slot bank full while the queue lasts — optionally injecting a device
failure mid-run, and returns the session's
:class:`~repro_torch.serving.decode_session.ServeReport` (tokens/sec and p50/p99
per-token + end-to-end latency, measured and engine-priced side by side).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def generate_requests(session, *, n_streams: int, rate: float,
                      prompt_len: int = 8, max_new: int = 4,
                      seed: int = 0) -> list:
    """Submit ``n_streams`` Poisson-arrival requests to the session.
    ``rate`` is arrivals per virtual second; ``prompt_len``/``max_new``
    may be ints or (lo, hi) ranges sampled per stream."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if isinstance(spec, tuple):
            return int(rng.integers(spec[0], spec[1] + 1))
        return int(spec)

    t = 0.0
    reqs = []
    for _ in range(n_streams):
        t += float(rng.exponential(1.0 / rate))
        prompt = rng.integers(0, session.cfg.vocab_size,
                              size=draw(prompt_len)).astype(np.int32)
        reqs.append(session.submit(prompt, draw(max_new), arrival=t))
    return reqs


def run_load(session, *, n_streams: int, rate: float,
             prompt_len: int = 8, max_new: int = 4, seed: int = 0,
             fail_ids: Sequence[int] = (),
             fail_at_step: Optional[int] = None,
             max_steps: int = 200_000):
    """End-to-end load-generator run: submit the Poisson streams, drain
    them under continuous batching (optionally failing ``fail_ids``
    devices at decode step ``fail_at_step``), and return the latency
    report."""
    generate_requests(session, n_streams=n_streams, rate=rate,
                      prompt_len=prompt_len, max_new=max_new, seed=seed)
    return session.run(max_steps=max_steps, fail_ids=fail_ids,
                       fail_at_step=fail_at_step)
