"""Paged KV cache: a fixed-size device page pool with prefix sharing.

Counterpart of ``mxnet_tpu/serving/paged_cache.py``.  K/V live in pools of
fixed-size pages, ``[layers, pages, page_tokens, kv_units]`` tensors on the
model's device; a sequence owns a page table (an ordered list of physical
page ids), admission is governed by free pages, and a retired sequence's
pages recycle immediately.

Prefix caching: a complete page is content-hashed over the chain
(previous page hash, its token ids), so the hash covers the whole prefix
that its K/V depend on.  A later request maps every matching page instead
of recomputing it; matched pages are reference-counted and never written
again.  Pages whose count drops to zero keep their hash and park in an LRU
"cached free" set, reclaimed only when the clean free list runs dry.  The
hashes are byte-identical to the JAX package's (sha256 over int64 bytes).

Page 0 is a reserved scratch page: padded page-table entries point at it.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["PagePool", "pages_needed", "page_hash_chain"]


def pages_needed(tokens: int, page_tokens: int) -> int:
    """ceil(tokens / page_tokens): pages covering a token span."""
    return -(-int(tokens) // int(page_tokens))


def page_hash_chain(tokens: Sequence[int], page_tokens: int) -> List[str]:
    """Chained content hashes of every complete page of ``tokens``:
    ``h[i] = sha256(h[i-1] || tokens_of_page_i)``, so ``h[i]`` identifies
    the entire prefix through page i."""
    out: List[str] = []
    prev = b""
    for i in range(len(tokens) // page_tokens):
        chunk = tokens[i * page_tokens:(i + 1) * page_tokens]
        hsh = hashlib.sha256(prev + np.asarray(chunk, dtype=np.int64).tobytes())
        out.append(hsh.hexdigest())
        prev = out[-1].encode()
    return out


class PagePool:
    """Device-resident K/V page pool for one model.

    ``k``/``v`` are ``[num_layers, num_pages, page_tokens, kv_units]``
    tensors of ``dtype`` on ``device`` (default ``cuda``); page 0 is
    scratch.  All bookkeeping (free list, reference counts, prefix-hash
    index) is on the host under one lock.
    """

    def __init__(self, num_layers: int, num_pages: int, page_tokens: int,
                 kv_units: int, name: str = "", prefix_cache: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        if num_pages < 2:
            raise MXNetError(f"page pool needs >= 2 pages (1 scratch + 1 "
                             f"allocatable), got {num_pages}")
        if page_tokens < 1:
            raise MXNetError(f"page_tokens must be >= 1, got {page_tokens}")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self.kv_units = int(kv_units)
        self.name = name or "default"
        self.prefix_cache_enabled = bool(prefix_cache)
        shape = (num_layers, num_pages, page_tokens, kv_units)
        dev = resolve_device(device)
        self.k = torch.zeros(shape, dtype=dtype, device=dev)
        self.v = torch.zeros(shape, dtype=dtype, device=dev)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop()->1
        self._ref: Dict[int, int] = {}
        self._hash_of: Dict[int, str] = {}      # live or cached hashed pages
        self._pid_of: Dict[str, int] = {}       # hash -> pid (unique)
        self._cached: "OrderedDict[str, int]" = OrderedDict()  # LRU, ref==0
        self.prefix_lookups = 0  # complete prompt pages offered at admission
        self.prefix_hits = 0     # of those, pages mapped onto a live page
        self.evictions = 0       # cached pages reclaimed for new allocations

    # ------------------------------------------------------------ accounting
    def available(self) -> int:
        """Pages an allocation could obtain now: clean free plus
        reclaimable cached."""
        with self._lock:
            return len(self._free) + len(self._cached)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pages": self.num_pages - 1, "free": len(self._free),
                    "cached": len(self._cached), "active": len(self._ref),
                    "page_tokens": self.page_tokens,
                    "prefix_lookups": self.prefix_lookups,
                    "prefix_hits": self.prefix_hits,
                    "evictions": self.evictions}

    # ------------------------------------------------------------ allocation
    def _reclaim_locked(self) -> Optional[int]:
        if not self._cached:
            return None
        hsh, pid = self._cached.popitem(last=False)  # LRU
        del self._pid_of[hsh]
        del self._hash_of[pid]
        self.evictions += 1
        return pid

    def allocate(self, n: int) -> List[int]:
        """Take ``n`` pages (refcount 1 each): clean pages first, then LRU
        reclamation of cached zero-ref pages.  Raises when the pool cannot
        satisfy the request; callers gate on :meth:`available` first."""
        with self._lock:
            if n > len(self._free) + len(self._cached):
                raise MXNetError(
                    f"page pool {self.name!r} exhausted: need {n}, have "
                    f"{len(self._free)} free + {len(self._cached)} cached")
            out: List[int] = []
            for _ in range(int(n)):
                pid = self._free.pop() if self._free \
                    else self._reclaim_locked()
                self._ref[pid] = 1
                out.append(pid)
            return out

    def release(self, pids: Sequence[int]) -> None:
        """Drop one reference per page; zero-ref pages return to the clean
        free list, or park in the cached LRU when they carry a hash."""
        with self._lock:
            for pid in pids:
                r = self._ref.get(pid)
                if r is None:
                    continue
                if r > 1:
                    self._ref[pid] = r - 1
                    continue
                del self._ref[pid]
                hsh = self._hash_of.get(pid)
                if hsh is not None and self.prefix_cache_enabled:
                    self._cached[hsh] = pid
                    self._cached.move_to_end(hsh)
                else:
                    self._hash_of.pop(pid, None)
                    if hsh is not None:
                        self._pid_of.pop(hsh, None)
                    self._free.append(pid)

    # ---------------------------------------------------------- prefix cache
    def match_prefix(self, hashes: Sequence[str]) -> List[int]:
        """Longest chain of already-materialized pages for a prompt: walks
        ``hashes`` in order, increfs each matched page (resurrecting cached
        zero-ref pages) and stops at the first miss."""
        if not self.prefix_cache_enabled:
            return []
        out: List[int] = []
        with self._lock:
            self.prefix_lookups += len(hashes)
            for hsh in hashes:
                pid = self._pid_of.get(hsh)
                if pid is None:
                    break
                if pid in self._ref:
                    self._ref[pid] += 1
                else:
                    self._cached.pop(hsh, None)
                    self._ref[pid] = 1
                out.append(pid)
            self.prefix_hits += len(out)
        return out

    def register(self, pid: int, hsh: str) -> None:
        """Bind a complete page's chain hash so later prompts can map it.
        First writer wins: a hash already bound keeps its page."""
        if not self.prefix_cache_enabled:
            return
        with self._lock:
            if hsh in self._pid_of or pid in self._hash_of:
                return
            self._pid_of[hsh] = pid
            self._hash_of[pid] = hsh

    # ---------------------------------------------------------------- writes
    def write(self, k_new: torch.Tensor, v_new: torch.Tensor,
              pids: Sequence[int], offsets: Sequence[int]) -> None:
        """Write per-token K/V into the pools: ``k_new``/``v_new`` are
        ``[layers, n, kv_units]``, entry i landing at ``(pids[i],
        offsets[i])``.  An in-place ``index_put_`` on the pool tensors; it
        takes the place of the JAX package's donated scatter, which needed
        buffer donation (and power-of-two padded index vectors) to avoid
        copying the pool through each update."""
        if not len(pids):
            return
        dev = self.k.device
        pid_t = torch.as_tensor(np.asarray(pids, dtype=np.int64), device=dev)
        off_t = torch.as_tensor(np.asarray(offsets, dtype=np.int64), device=dev)
        with self._lock:
            self.k[:, pid_t, off_t] = k_new.to(self.k.dtype)
            self.v[:, pid_t, off_t] = v_new.to(self.v.dtype)

    def locate(self, table: Sequence[int], position: int) -> Tuple[int, int]:
        """(physical page id, in-page offset) of an absolute token position
        under a sequence's page table."""
        return (int(table[position // self.page_tokens]),
                int(position % self.page_tokens))
