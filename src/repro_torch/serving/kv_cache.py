"""PS-hosted paged KV cache for fleet-backed decode serving, with the pools
as tensors on the session's device (port of
``src/repro/serving/kv_cache.py``).

One pool of fixed-size pages per cached tensor (K/V for GQA families,
the latent c_kv and rope key k_pe for MLA), stacked over layers::

    k pool: (L, n_pages, page, K, hd)      v pool: same
    ckv pool: (L, n_pages, page, r)        kpe pool: (L, n_pages, page, rd)

Each live request holds a page table (ordered page ids) and a token count.
Pages are reserved at admission for the request's whole budget and return
to the free list on retirement.  ``gather`` builds the contiguous
(L, B, Smax, ...) views the decode step reads; ``page_table_array`` gives
the operands of the paged decode kernel, which reads the pools in place.
``kv_int8=True`` stores K/V int8 with per-(token, head) float16 scales.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# symmetric int8 over head_dim with per-(token, head) float16 scales
from repro_torch.models.model import _kv_quantize as quantize_kv


@dataclass
class PageTable:
    """One request's view of the pool: ordered page ids + token count."""
    rid: int
    pages: List[int]
    length: int = 0              # tokens written so far


@dataclass
class CacheStats:
    n_pages: int
    page_size: int
    n_free: int
    n_requests: int
    peak_pages_used: int

    @property
    def n_used(self) -> int:
        return self.n_pages - self.n_free

    @property
    def utilization(self) -> float:
        return self.n_used / max(self.n_pages, 1)


class PagedKVCache:
    """Fixed-page KV pool with per-request page tables (module
    docstring)."""

    def __init__(self, cfg, *, n_pages: int, page_size: int,
                 kv_int8: bool = False, dtype=torch.float32,
                 device="cuda"):
        if cfg.rwkv or cfg.ssm or cfg.hybrid_parallel or cfg.attn_free \
                or cfg.enc_dec:
            raise ValueError(
                f"arch {cfg.name!r}: paged serving needs a KV-cache family "
                "(GQA/MHA or MLA); recurrent/enc-dec states are not paged")
        if kv_int8 and cfg.mla:
            raise ValueError("kv_int8 applies to K/V caches; MLA caches "
                             "the compressed c_kv/k_pe instead")
        self.cfg = cfg
        self.page = int(page_size)
        self.n_pages = int(n_pages)
        self.kv_int8 = bool(kv_int8)
        self.device = torch.device(device)
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shp = (L, self.n_pages, self.page)
        kv_dt = torch.int8 if kv_int8 else dtype
        if cfg.mla:
            widths = {"ckv": (cfg.kv_lora_rank,), "kpe": (cfg.rope_head_dim,)}
        else:
            widths = {"k": (K, hd), "v": (K, hd)}
        self.pools: Dict[str, torch.Tensor] = {
            nm: torch.zeros(shp + w, dtype=kv_dt, device=self.device)
            for nm, w in widths.items()}
        if kv_int8:
            for nm in ("k_scale", "v_scale"):
                self.pools[nm] = torch.zeros(shp + (K,), dtype=torch.float16,
                                             device=self.device)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.tables: Dict[int, PageTable] = {}
        self.peak_pages_used = 0

    # ------------------------------------------------------------ alloc/free --

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page))

    def can_alloc(self, n_tokens: int) -> bool:
        return len(self._free) >= self.pages_for(n_tokens)

    def alloc(self, rid: int, n_tokens: int) -> PageTable:
        """Reserve pages for a request's full budget; MemoryError when the
        free list is short."""
        if rid in self.tables:
            raise ValueError(f"request {rid} already has pages")
        need = self.pages_for(n_tokens)
        if len(self._free) < need:
            raise MemoryError(
                f"request {rid}: {need} pages needed, "
                f"{len(self._free)} free")
        pt = PageTable(rid=rid, pages=[self._free.pop() for _ in range(need)])
        self.tables[rid] = pt
        used = self.n_pages - len(self._free)
        self.peak_pages_used = max(self.peak_pages_used, used)
        return pt

    def free(self, rid: int) -> None:
        """Retire a request: its pages return to the free list (stale rows
        stay; the occupancy mask hides them)."""
        pt = self.tables.pop(rid)
        self._free.extend(reversed(pt.pages))

    def stats(self) -> CacheStats:
        return CacheStats(n_pages=self.n_pages, page_size=self.page,
                          n_free=len(self._free),
                          n_requests=len(self.tables),
                          peak_pages_used=self.peak_pages_used)

    # --------------------------------------------------------------- writes --

    def _flat(self, rid: int, pos) -> np.ndarray:
        """Flat pool row index (page_id * page + offset) for absolute
        position(s) ``pos`` of request ``rid``."""
        pt = self.tables[rid]
        pos = np.asarray(pos)
        pages = np.asarray(pt.pages, np.int64)
        return pages[pos // self.page] * self.page + pos % self.page

    def _scatter(self, idx: np.ndarray, values: Dict[str, torch.Tensor]):
        ix = torch.as_tensor(idx, device=self.device)
        for nm, val in values.items():
            pool = self.pools[nm]
            flat = pool.view((pool.shape[0], -1) + tuple(pool.shape[3:]))
            flat[:, ix] = val.to(device=self.device, dtype=pool.dtype)

    def write_prompt(self, rid: int, values: Dict[str, torch.Tensor]) -> None:
        """Ingest a prefilled prompt: ``values[name]`` is (L, P, ...); float
        K/V are quantized on write when the pool is int8."""
        values = dict(values)
        if self.kv_int8 and "k_scale" not in values:
            for nm in ("k", "v"):
                values[nm], values[nm + "_scale"] = quantize_kv(values[nm])
        P = next(iter(values.values())).shape[1]
        self._scatter(self._flat(rid, np.arange(P)), values)
        self.tables[rid].length = max(self.tables[rid].length, P)

    def write_tokens(self, rids: Sequence[int], pos: Sequence[int],
                     values: Dict[str, torch.Tensor]) -> None:
        """Scatter one step's new-token entries: ``values[name]`` is
        (L, B, ...), already in the pool's form."""
        if not len(rids):
            return
        idx = np.stack([self._flat(r, p) for r, p in zip(rids, pos)])
        self._scatter(idx, values)
        for r, p in zip(rids, pos):
            self.tables[r].length = max(self.tables[r].length, int(p) + 1)

    # -------------------------------------------------------------- gathers --

    def gather(self, rids: Sequence[Optional[int]], cache_len: int
               ) -> Dict[str, torch.Tensor]:
        """Contiguous (L, B, cache_len, ...) views for the decode step, one
        fancy-index per pool.  ``None`` rids (inactive slots) read rows of
        page 0, hidden by the occupancy mask."""
        idx = np.zeros((len(rids), cache_len), np.int64)
        offs = np.arange(cache_len)
        for b, rid in enumerate(rids):
            if rid is None:
                continue
            pt = self.tables[rid]
            n = min(cache_len, len(pt.pages) * self.page)
            idx[b, :n] = self._flat(rid, offs[:n])
        ix = torch.as_tensor(idx, device=self.device)
        out = {}
        for nm, pool in self.pools.items():
            flat = pool.view((pool.shape[0], -1) + tuple(pool.shape[3:]))
            out[nm] = flat[:, ix]          # (L, B, cache_len, ...)
        return out

    def page_table_array(self, rids: Sequence[Optional[int]]
                         ) -> "tuple[np.ndarray, np.ndarray]":
        """(B, max_pages) int32 page table + (B,) int32 lengths, the
        operands of the paged decode kernel.  Unused entries point at page
        0 (masked by the length)."""
        maxp = max((len(self.tables[r].pages) for r in rids
                    if r is not None), default=1)
        pt = np.zeros((len(rids), maxp), np.int32)
        ln = np.zeros((len(rids),), np.int32)
        for b, rid in enumerate(rids):
            if rid is None:
                continue
            t = self.tables[rid]
            pt[b, :len(t.pages)] = t.pages
            ln[b] = t.length
        return pt, ln
