"""Iteration-level continuous batching for decoder LMs.

Counterpart of ``mxnet_tpu/serving/generation.py``.  Two decode engines
share one scheduler:

* **paged KV cache** (the default for models with ``cache_forward``):
  prompt prefill runs a ``[1, L]`` chunk forward that returns per-layer K/V,
  written into a device page pool (:mod:`.paged_cache`); decode then runs a
  ``[slots, 1]`` single-token forward that gathers each slot's pages and
  attends over them.  Admission is governed by free pages, retirement
  recycles them, and identical prompt prefixes map onto the same pages.
* **dense no-cache** (``kv_cache=False``): every step re-runs the full
  ``[slots, L]`` prefix through the model's ``forward``, whose attention
  is the flash kernel.

Both engines emit the token streams of solo greedy decoding
(:func:`greedy_decode`): the paged attention reproduces the dense causal
support and follows the flash op's plain formula.  PyTorch runs eagerly,
so where the JAX package compiled one executable per shape the port calls
the model directly; the power-of-two length and page ladders stay, so the
two packages run the same shapes.

Speculative decoding, KV export and import between replicas, warmup, and
the tracing, metrics, fault-injection and health hooks wait for later
slices.
"""
from __future__ import annotations

import queue
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..base import MXNetError, RequestCancelledError, env as _env, row_bucket
from .hostbuf import HostBufferPool
from .paged_cache import PagePool, page_hash_chain, pages_needed
from .stats import ServingStats

__all__ = ["GenerationScheduler", "TokenStream", "greedy_decode",
           "length_bucket", "DEFAULT_EOS"]


class _DefaultEos:
    """Sentinel for :meth:`GenerationScheduler.submit`'s ``eos_id``: "use
    the scheduler's default", so ``None`` can still mean "no eos"."""

    def __repr__(self):
        return "<scheduler default eos>"


DEFAULT_EOS = _DefaultEos()


class TokenStream:
    """Incremental consumer surface for one generation request: the step
    loop pushes each token as it is produced and the consumer iterates
    them as they arrive.  Ends when generation is done, or re-raises the
    request's failure at the iteration site."""

    __slots__ = ("_q",)

    def __init__(self):
        self._q = queue.Queue()

    def _push(self, tokens) -> None:
        for t in tokens:
            self._q.put(("tok", int(t)))

    def _finish(self) -> None:
        self._q.put(("done", None))

    def _fail(self, exc: BaseException) -> None:
        self._q.put(("err", exc))

    def events(self, timeout: Optional[float] = None):
        """Yield tokens as they arrive; return on completion, raise the
        request's failure (``queue.Empty`` on ``timeout``)."""
        while True:
            kind, val = self._q.get(timeout=timeout)
            if kind == "tok":
                yield val
            elif kind == "err":
                raise val
            else:
                return

    def __iter__(self):
        return self.events()


def length_bucket(n: int, minimum: int = 16,
                  maximum: Optional[int] = None) -> int:
    """Next power-of-two length >= n (floor ``minimum``, cap ``maximum``)."""
    b = row_bucket(n, minimum)
    if maximum is not None:
        if n > maximum:
            raise MXNetError(f"sequence of {n} tokens exceeds max_length "
                             f"{maximum}")
        b = min(b, maximum)
    return b


def _next_token(row: np.ndarray) -> int:
    """Greedy pick over one logits row (first-max tie-break)."""
    return int(np.argmax(row))


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _rows(logits: torch.Tensor, rows: Sequence[int], cols: Sequence[int]
          ) -> np.ndarray:
    """Host float32 copy of ``logits[rows[i], cols[i]]``, one row each:
    only the rows that are sampled leave the device."""
    dev = logits.device
    r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)
    c = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=dev)
    return logits[r, c].float().cpu().numpy()


@torch.no_grad()
def greedy_decode(model, prompt: Sequence[int], max_new_tokens: int,
                  eos_id: Optional[int] = None, min_bucket: int = 16,
                  max_length: Optional[int] = None) -> List[int]:
    """Solo greedy decoding over the scheduler's length ladder: the oracle
    for the continuous-batching parity tests."""
    dev = _model_device(model)
    toks = [int(t) for t in prompt]
    out: List[int] = []
    for _ in range(max_new_tokens):
        L = length_bucket(len(toks), min_bucket, max_length)
        arr = np.zeros((1, L), dtype=np.int64)
        arr[0, :len(toks)] = toks
        logits = model(torch.from_numpy(arr).to(dev))
        nt = _next_token(_rows(logits, [0], [len(toks) - 1])[0])
        out.append(nt)
        toks.append(nt)
        if eos_id is not None and nt == eos_id:
            break
    return out


class _Sequence:
    __slots__ = ("prompt", "max_new", "eos_id", "generated", "future",
                 "pages", "cached", "prefix_pages", "t_submit", "stream",
                 "streamed", "rid")

    def __init__(self, prompt, max_new, eos_id, stream=None, rid=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.generated: List[int] = []
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.pages: List[int] = []       # page table (physical ids)
        self.cached = 0                  # valid cache length
        self.prefix_pages = 0            # pages mapped from the prefix cache
        self.stream: Optional[TokenStream] = stream
        self.streamed = 0                # tokens already pushed to `stream`
        self.rid = rid

    @property
    def tokens(self) -> List[int]:
        return self.prompt + self.generated

    def done(self) -> bool:
        if len(self.generated) >= self.max_new:
            return True
        return (self.eos_id is not None and bool(self.generated)
                and self.generated[-1] == self.eos_id)


class _PagedLM:
    """One model's cached-decode surface: a page pool plus the model's
    ``cache_forward``."""

    def __init__(self, model, pool: PagePool):
        self.model = model
        self.pool = pool
        self._hb = HostBufferPool()

    def forward(self, tok: np.ndarray, pos: np.ndarray, lens: np.ndarray,
                tables: Sequence[Sequence[int]], page_bucket: int):
        """One chunk forward; returns device tensors (logits [B, C, V],
        k_new, v_new [layers, B, C, kv]).  ``tables`` rows are padded with
        the scratch page to ``page_bucket`` columns."""
        b = tok.shape[0]
        table = self._hb.get((b, page_bucket), np.int64, tag="table")
        for i, row in enumerate(tables):
            if len(row):
                table[i, :len(row)] = row
        dev = self.pool.k.device
        put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64)).to(dev)
        return self.model.cache_forward(put(tok), put(pos), put(lens),
                                        put(table), self.pool.k, self.pool.v)


def _page_bucket(n_pages: int) -> int:
    """Power-of-two page-table width (0 stays 0: the empty-window prefill)."""
    return 0 if n_pages <= 0 else row_bucket(n_pages, 1)


class GenerationScheduler:
    """Continuous batching over a token-in/logits-out decoder.

    ``model`` is an ``nn.Module`` mapping int64 tokens ``[B, S]`` on its
    device to logits ``[B, S, vocab]`` (the :class:`LlamaModel` contract).
    Requests enter via :meth:`submit`; :meth:`step` admits queued requests
    into free slots, advances every active sequence by one token and
    retires finished ones; :meth:`run` steps until idle.

    Engine selection: ``kv_cache=None`` uses the paged engine when the
    model has ``cache_forward`` and ``MXNET_SERVING_KV_CACHE`` is on, else
    the dense engine; ``True``/``False`` force it.  The page pool lives on
    the model's device in the model's dtype.
    """

    def __init__(self, model, max_slots: int = 4, eos_id: Optional[int] = None,
                 min_bucket: int = 16, max_length: Optional[int] = None,
                 kv_cache: Optional[bool] = None,
                 page_tokens: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 name: Optional[str] = None):
        self.model = model
        self.max_slots = int(max_slots)
        self.eos_id = eos_id
        self.min_bucket = int(min_bucket)
        self.max_length = max_length
        self.name = name or type(model).__name__
        self._stats = ServingStats(self.name)
        self._lock = threading.Lock()
        self._pending: "deque[_Sequence]" = deque()
        self._slots: List[Optional[_Sequence]] = [None] * self.max_slots
        self._rids: dict = {}   # rid -> live _Sequence (cancel handle)
        self._device = _model_device(model)
        self.steps = 0
        self.admitted = 0
        self.retired = 0
        self.cancelled = 0
        self.logit_rows = 0     # logits rows copied to the host and sampled
        self.nonfinite_rows = 0  # of those, rows holding a NaN or Inf
        self._hb = HostBufferPool()

        if kv_cache is None:
            kv_cache = (bool(_env.MXNET_SERVING_KV_CACHE)
                        and hasattr(model, "cache_forward"))
        elif kv_cache and not hasattr(model, "cache_forward"):
            raise MXNetError(
                f"kv_cache=True but {type(model).__name__} has no "
                "cache_forward; pass kv_cache=False for the dense path")
        self.paged = bool(kv_cache)

        if self.paged:
            self.page_tokens = int(page_tokens
                                   or _env.MXNET_SERVING_PAGE_TOKENS)
            if prefix_cache is None:
                prefix_cache = bool(_env.MXNET_SERVING_PREFIX_CACHE)
            layers, kv_units, model_max = model.kv_cache_spec()
            if self.max_length is None:
                # past the RoPE table, cache_forward's position clamp would
                # decode garbage: the table is the honest default limit
                self.max_length = model_max
            elif self.max_length > model_max:
                raise MXNetError(f"max_length {self.max_length} exceeds the "
                                 f"model's RoPE table ({model_max})")
            np_pages = int(num_pages or _env.MXNET_SERVING_KV_PAGES)
            if not np_pages:
                np_pages = 1 + self.max_slots * pages_needed(
                    self.max_length, self.page_tokens)
            dtype = next(model.parameters()).dtype
            self._target = _PagedLM(model, PagePool(
                layers, np_pages, self.page_tokens, kv_units, name=self.name,
                prefix_cache=prefix_cache, dtype=dtype, device=self._device))

    # ------------------------------------------------------------- intake
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Union[Optional[int], _DefaultEos] = DEFAULT_EOS,
               stream: Optional[TokenStream] = None,
               rid: Optional[str] = None) -> Future:
        """Queue a prompt; the Future resolves to the generated token list.

        ``eos_id`` defaults to the scheduler's own; pass ``None`` to disable
        eos for this request.  Rejects up front anything that could outgrow
        ``max_length`` (or the page pool) mid-decode.  ``stream`` receives
        every token as it is produced; ``rid`` names the request for
        :meth:`cancel` (assigned when omitted)."""
        if not len(prompt):
            raise MXNetError("empty prompt")
        if (self.max_length is not None
                and len(prompt) + int(max_new_tokens) > self.max_length):
            raise MXNetError(
                f"prompt of {len(prompt)} tokens + max_new_tokens "
                f"{max_new_tokens} exceeds max_length {self.max_length}")
        if self.paged:
            need = pages_needed(len(prompt) + int(max_new_tokens),
                                self.page_tokens)
            cap = self._target.pool.num_pages - 1
            if need > cap:
                raise MXNetError(
                    f"request needs {need} KV pages but the pool only has "
                    f"{cap}; raise MXNET_SERVING_KV_PAGES or num_pages")
        seq = _Sequence(prompt, max_new_tokens,
                        self.eos_id if eos_id is DEFAULT_EOS else eos_id,
                        stream=stream,
                        rid=str(rid) if rid is not None else uuid.uuid4().hex)
        with self._lock:
            if seq.rid in self._rids:
                raise MXNetError(f"{self.name}: request id {seq.rid!r} is "
                                 "already in flight")
            self._rids[seq.rid] = seq
            self._pending.append(seq)
        return seq.future

    def cancel(self, rid: str) -> bool:
        """Cancel the live request ``rid`` wherever it is (pending queue or
        active slot), freeing its KV pages at once and failing its Future
        and stream with :class:`RequestCancelledError`.  Returns False when
        the rid is unknown or already finished."""
        with self._lock:
            seq = self._rids.pop(str(rid), None)
            if seq is None:
                return False
            try:
                self._pending.remove(seq)
            except ValueError:
                for i, s in enumerate(self._slots):
                    if s is seq:
                        self._slots[i] = None
                        break
            if self.paged:
                self._free_pages(seq)
            self.cancelled += 1
        exc = RequestCancelledError(
            f"{self.name}: request {rid} cancelled "
            f"({len(seq.generated)} tokens generated)")
        if seq.stream is not None:
            seq.stream._fail(exc)
        if not seq.future.done():
            seq.future.set_exception(exc)
        return True

    # ------------------------------------------------------------- sampling
    def _sample(self, logits: torch.Tensor, rows: Sequence[int],
                cols: Sequence[int]) -> List[int]:
        """Greedy tokens at ``logits[rows[i], cols[i]]``; counts the rows
        that hold a non-finite value."""
        host = _rows(logits, rows, cols)
        self.logit_rows += len(host)
        self.nonfinite_rows += int((~np.isfinite(host).all(axis=1)).sum())
        return [_next_token(r) for r in host]

    # ------------------------------------------------------------- dense
    def _forward(self, tokens_np: np.ndarray) -> torch.Tensor:
        return self.model(torch.from_numpy(tokens_np).to(self._device))

    def _prefill_dense(self, seq: _Sequence) -> None:
        L = length_bucket(len(seq.prompt), self.min_bucket, self.max_length)
        arr = self._hb.get((1, L), np.int64, tag="prefill")
        arr[0, :len(seq.prompt)] = seq.prompt
        seq.generated.extend(self._sample(self._forward(arr), [0],
                                          [len(seq.prompt) - 1]))

    def _decode_dense(self, active) -> int:
        L = length_bucket(max(len(s.tokens) for _, s in active),
                          self.min_bucket, self.max_length)
        arr = self._hb.get((self.max_slots, L), np.int64, tag="tok")
        for i, s in active:
            arr[i, :len(s.tokens)] = s.tokens
        toks = self._sample(self._forward(arr), [i for i, _ in active],
                            [len(s.tokens) - 1 for _, s in active])
        for (_, s), t in zip(active, toks):
            s.generated.append(t)
        return L

    # ------------------------------------------------------------- paged
    def _admission_ok(self, seq: _Sequence) -> bool:
        """Page-governed admission: map the prompt's cached prefix, then
        reserve the worst-case page need up front so the step loop can
        never strand a half-grown sequence."""
        pool = self._target.pool
        m = len(seq.prompt)
        hashes = page_hash_chain(seq.prompt, self.page_tokens)
        # share only complete pages strictly before the last prompt token:
        # the final token always runs through prefill for its logits
        shareable = min(len(hashes), (m - 1) // self.page_tokens)
        shared = pool.match_prefix(hashes[:shareable])
        own = pages_needed(m + seq.max_new, self.page_tokens) - len(shared)
        if pool.available() < own:
            pool.release(shared)
            return False
        seq.pages = shared + pool.allocate(own)
        seq.prefix_pages = len(shared)
        return True

    def _free_pages(self, seq: _Sequence) -> None:
        if seq.pages:
            self._target.pool.release(seq.pages)
            seq.pages = []

    def _prefill_paged(self, seq: _Sequence) -> None:
        pool = self._target.pool
        m = len(seq.prompt)
        c = seq.prefix_pages * self.page_tokens   # tokens already cached
        suffix = seq.prompt[c:]
        L = length_bucket(len(suffix), self.min_bucket, self.max_length)
        tok = self._hb.get((1, L), np.int64, tag="prefill")
        tok[0, :len(suffix)] = suffix
        logits, k_new, v_new = self._target.forward(
            tok, np.array([c]), np.array([c]),
            [seq.pages[:seq.prefix_pages]], _page_bucket(seq.prefix_pages))
        # write the suffix K/V (positions c .. m-1) into this request's pages
        where = [pool.locate(seq.pages, p) for p in range(c, m)]
        pool.write(k_new[:, 0, :len(suffix)], v_new[:, 0, :len(suffix)],
                   [p for p, _ in where], [o for _, o in where])
        seq.cached = m
        # register the freshly completed prompt pages for later prefix hits
        for j, hsh in enumerate(page_hash_chain(seq.prompt, self.page_tokens)):
            pool.register(seq.pages[j], hsh)
        seq.generated.extend(self._sample(logits, [0], [len(suffix) - 1]))

    def _decode_paged(self, active) -> int:
        """One token for every active slot through the ``[slots, 1]``
        decode forward reading the page pool."""
        pool = self._target.pool
        tok = self._hb.get((self.max_slots, 1), np.int64, tag="tok")
        pos = self._hb.get((self.max_slots,), np.int64, tag="pos")
        lens = self._hb.get((self.max_slots,), np.int64, tag="len")
        tables: List[List[int]] = [[] for _ in range(self.max_slots)]
        for i, s in active:
            tok[i, 0] = s.tokens[-1]
            pos[i] = lens[i] = s.cached
            tables[i] = s.pages[:pages_needed(s.cached, self.page_tokens)]
        pb = _page_bucket(max(len(t) for t in tables))
        logits, k_new, v_new = self._target.forward(tok, pos, lens, tables, pb)
        idx = torch.as_tensor([i for i, _ in active], device=k_new.device)
        where = [pool.locate(s.pages, s.cached) for _, s in active]
        pool.write(k_new[:, idx, 0], v_new[:, idx, 0],
                   [p for p, _ in where], [o for _, o in where])
        toks = self._sample(logits, [i for i, _ in active], [0] * len(active))
        for (_, s), t in zip(active, toks):
            s.cached += 1
            s.generated.append(t)
        return max(len(s.tokens) for _, s in active)

    # ------------------------------------------------------------- stepping
    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: admit, decode one token for every
        active sequence, retire.  Returns True while any work remains."""
        finished: List[_Sequence] = []
        failed: List = []  # (sequence, exception): fault isolation per step
        with self._lock:
            # admission at the step boundary: prefill fills each free slot
            # (a sequence that finishes at prefill retires at once and the
            # slot admits the next request).  set_running_or_notify_cancel
            # drops requests cancelled while queued and pins the future
            # against later cancellation.
            for i in range(self.max_slots):
                while self._slots[i] is None and self._pending:
                    seq = self._pending[0]
                    if self.paged and not seq.future.cancelled() \
                            and not self._admission_ok(seq):
                        break  # no pages free: the FIFO head waits
                    self._pending.popleft()
                    if not seq.future.set_running_or_notify_cancel():
                        if self.paged:
                            self._free_pages(seq)
                        self._rids.pop(seq.rid, None)
                        continue
                    try:
                        if self.paged:
                            self._prefill_paged(seq)
                        else:
                            self._prefill_dense(seq)
                    except Exception as e:  # noqa: BLE001 — fail THIS future
                        if self.paged:
                            self._free_pages(seq)
                        self._rids.pop(seq.rid, None)
                        failed.append((seq, e))
                        continue
                    self.admitted += 1
                    if seq.done():
                        self._retire(i, seq, finished, occupied=False)
                    else:
                        self._slots[i] = seq
                if self._slots[i] is None and self._pending:
                    break  # paged admission stalled; later slots wait too
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
            if active:
                try:
                    L = (self._decode_paged(active) if self.paged
                         else self._decode_dense(active))
                    for i, s in active:
                        if s.done():
                            self._retire(i, s, finished)
                    self.steps += 1
                    self._stats.record_batch(len(active), len(active), L)
                except Exception as e:  # noqa: BLE001 — a decode fault fails
                    # every in-flight sequence instead of wedging its future
                    for i, s in active:
                        self._slots[i] = None
                        if self.paged:
                            self._free_pages(s)
                        self._rids.pop(s.rid, None)
                        failed.append((s, e))
            more = bool(self._pending
                        or any(s is not None for s in self._slots))
            emits = []
            for s in self._slots:
                if (s is not None and s.stream is not None
                        and len(s.generated) > s.streamed):
                    emits.append((s.stream, s.generated[s.streamed:]))
                    s.streamed = len(s.generated)
        # futures resolve outside the lock: done-callbacks may re-enter the
        # scheduler (e.g. chain the next request via submit())
        for stream, delta in emits:
            stream._push(delta)
        for seq in finished:
            if seq.stream is not None:
                seq.stream._push(seq.generated[seq.streamed:])
                seq.streamed = len(seq.generated)
                seq.stream._finish()
            seq.future.set_result(list(seq.generated))
            self._stats.record_request(
                (time.monotonic() - seq.t_submit) * 1e6)
        for seq, e in failed:
            if seq.stream is not None:
                seq.stream._fail(e)
            if not seq.future.done():
                seq.future.set_exception(e)
        return more

    def _retire(self, slot: int, seq: _Sequence, finished: List[_Sequence],
                occupied: bool = True):
        if occupied:
            self._slots[slot] = None
        if self.paged:
            self._free_pages(seq)
        self._rids.pop(seq.rid, None)
        self.retired += 1
        finished.append(seq)

    def run(self) -> int:
        """Step until every submitted sequence has retired; returns the
        number of iterations executed."""
        n = 0
        while self.step():
            n += 1
        return n

    # ------------------------------------------------------------- stats
    def stats_snapshot(self):
        snap = {"steps": self.steps, "admitted": self.admitted,
                "retired": self.retired, "cancelled": self.cancelled,
                "pending": len(self._pending),
                "active": sum(s is not None for s in self._slots),
                "engine": "paged" if self.paged else "dense",
                "logit_rows": self.logit_rows,
                "nonfinite_rows": self.nonfinite_rows}
        if self.paged:
            snap["page_pool"] = self._target.pool.stats()
        return snap
