"""Synthetic deterministic token pipeline.

In the paper's deployment the PS holds the dataset and streams batch
embeddings as part of the forward downlink dispatch (§6, training data
distribution); here the substrate produces deterministic host-side batches
(seeded, reproducible across restarts via the step counter) and shards them
over the mesh batch axes.  (Port: the same numpy pipeline; the reference's
``device_put_batch`` stays out -- callers move batches with
``torch.as_tensor``.)

A lightweight mixture of Zipfian unigrams + periodic motifs gives the loss a
learnable structure (examples/train_e2e.py drives loss well below the
uniform entropy floor).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticLM:
    """Deterministic synthetic corpus: Zipf unigram background with injected
    repeated motifs (n-gram structure a model can learn)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.motifs = rng.integers(0, v, size=(cfg.n_motifs, cfg.motif_len))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self.unigram = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self.unigram)
        # overwrite random spans with motifs
        n_spans = int(cfg.motif_prob * (S / cfg.motif_len))
        for b in range(B):
            starts = rng.integers(0, S + 1 - cfg.motif_len, size=n_spans)
            which = rng.integers(0, cfg.n_motifs, size=n_spans)
            for s0, w in zip(starts, which):
                toks[b, s0:s0 + cfg.motif_len] = self.motifs[w]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def modality_stubs(cfg, batch: int, seq: int, step: int,
                   seed: int = 0) -> dict:
    """The stubbed frontends' inputs of one training step, as the
    reference's training driver makes them (numpy, ``cfg.dtype``'s values
    in float32): vision configs get ``vision_embeds`` (batch, seq // 4,
    d), precomputed patch embeddings from ``default_rng((seed, step,
    7))``; encoder-decoder configs get ``encoder_feats`` (batch, 2 * seq,
    d), precomputed audio frames from ``default_rng((seed, step, 11))``.
    Text configs get nothing."""
    out = {}
    if cfg.modality == "vision":
        rng = np.random.default_rng((seed, step, 7))
        out["vision_embeds"] = rng.standard_normal(
            (batch, max(seq // 4, 1), cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        rng = np.random.default_rng((seed, step, 11))
        out["encoder_feats"] = rng.standard_normal(
            (batch, 2 * seq, cfg.d_model)).astype(np.float32)
    return out


def grid_positions(batch: int, seq: int, grid: tuple) -> np.ndarray:
    """M-RoPE positions (batch, seq, 3) int32 of a patch prefix on a
    ``grid = (rows, cols)`` at t = 0, patch j at (0, j // cols, j % cols),
    then text whose t = h = w run on from max(rows, cols), as Qwen2-VL
    lays out one image before its caption."""
    rows, cols = grid
    n = rows * cols
    pos = np.empty((seq, 3), np.int32)
    j = np.arange(min(n, seq))
    pos[:len(j)] = np.stack([np.zeros_like(j), j // cols, j % cols], -1)
    pos[len(j):] = (max(rows, cols) + np.arange(seq - len(j)))[:, None]
    return np.broadcast_to(pos, (batch, seq, 3)).copy()
