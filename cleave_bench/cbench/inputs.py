"""The benchmark's inputs, made from ``--seed``: the weights, drawn on
the device in one large call per type, and the token batches.

The token generator is a copy of the port's ``data/pipeline.py``
(``SyntheticLM``: Zipf unigrams with repeated motifs), kept here so that
the yardstick does not move with the program."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

ALIGN = 512          # elements: every leaf starts 1 KiB-aligned or more


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def make_weights(layout, seed: int,
                 device) -> Dict[tuple, torch.Tensor]:
    """Every leaf of ``layout`` ((path, shape, dtype, init) rows) as a view
    into one buffer per type, filled by one ``randn`` call and then scaled
    leaf by leaf: ("normal", std), ("uniform", lo, hi) or ("const",
    value).  The same seed gives the same bits."""
    gen = _generator(seed, device)
    offsets, sizes = {}, {}
    for path, shape, dtype, _ in layout:
        n = int(np.prod(shape))
        off = sizes.get(dtype, 0)
        offsets[path] = off
        sizes[dtype] = off + -(-n // ALIGN) * ALIGN
    bufs = {dt: torch.randn(n, dtype=dt, device=device, generator=gen)
            for dt, n in sizes.items()}
    out = {}
    for path, shape, dtype, init in layout:
        n = int(np.prod(shape))
        t = bufs[dtype][offsets[path]:offsets[path] + n].view(shape)
        kind = init[0]
        if kind == "normal":
            t.mul_(init[1])
        elif kind == "uniform":
            lo, hi = init[1], init[2]
            t.copy_(torch.rand(shape, device=device, generator=gen)
                    * (hi - lo) + lo)
        elif kind == "const":
            t.fill_(init[1])
        else:
            raise ValueError(f"unknown init {init!r}")
        out[path] = t
    return out


class Tokens:
    """Seeded batches of a Zipf unigram background with motifs pasted in
    (a copy of the port's ``SyntheticLM``); batch ``i`` depends only on
    (seed, i)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int,
                 zipf_a: float = 1.2, motif_len: int = 8, n_motifs: int = 64,
                 motif_prob: float = 0.5):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.motif_len, self.motif_prob = motif_len, motif_prob
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(0, vocab, size=(n_motifs, motif_len))
        p = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), zipf_a)
        self.unigram = p / p.sum()

    def numpy(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        B, S, ml = self.batch, self.seq, self.motif_len
        toks = rng.choice(self.vocab, size=(B, S + 1), p=self.unigram)
        n_spans = int(self.motif_prob * (S / ml))
        for b in range(B):
            starts = rng.integers(0, S + 1 - ml, size=n_spans)
            which = rng.integers(0, len(self.motifs), size=n_spans)
            for s0, w in zip(starts, which):
                toks[b, s0:s0 + ml] = self.motifs[w]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def device(self, indices, device) -> List[Dict[str, torch.Tensor]]:
        return [{k: torch.as_tensor(v, device=device)
                 for k, v in self.numpy(i).items()} for i in indices]
