"""Shared RNG normalization so every sampling entry point (fleet sampling,
executor verification, simulator experiments) accepts the same spec and runs
are bit-reproducible end to end."""
from __future__ import annotations

from typing import Union

import numpy as np

RngSpec = Union[np.random.Generator, int, None]


def as_rng(rng: RngSpec, default_seed: int = 0) -> np.random.Generator:
    """Normalize an rng spec: a Generator passes through, an int seeds a
    fresh Generator, None seeds with `default_seed`."""
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(default_seed if rng is None else rng)
