"""Iteration-level continuous batching for decoder LMs.

Counterpart of ``mxnet_tpu/serving/generation.py``.  Two decode engines
share one scheduler:

* **paged KV cache** (the default for models with ``cache_forward``):
  prompt prefill runs a ``[1, L]`` chunk forward that returns per-layer K/V,
  written into a device page pool (:mod:`.paged_cache`); decode then runs a
  ``[slots, 1]`` single-token forward that gathers each slot's pages and
  attends over them.  Admission is governed by free pages, retirement
  recycles them, and identical prompt prefixes map onto the same pages.
  **Speculative decoding** (``draft_model``): a smaller draft model, with
  its own page pool, proposes ``spec_tokens`` tokens in 1- or 2-token
  chunks, the target verifies them in one ``[slots, spec+1]`` forward, and
  greedy accept/rollback keeps the stream target-only greedy; rejected
  positions were never written inside the valid cache length.
* **dense no-cache** (``kv_cache=False``): every step re-runs the full
  ``[slots, L]`` prefix through the model's ``forward``, whose attention
  is the flash kernel.

Both engines emit the token streams of solo greedy decoding
(:func:`greedy_decode`): the paged attention reproduces the dense causal
support and follows the flash op's plain formula.  Each engine runs its
model through one :class:`~mxnet_tpu_torch.cached_op.CachedOp`, as the
JAX package does (``cache_forward`` for the paged engine and the draft,
``forward`` for the dense one), keyed on the shapes of the tokens,
positions, lengths and page table, so a signature is one JAX executable.
On the card a signature's first call runs eagerly and is the result, and
later calls replay its CUDA graph; the weights and the page pools are
read in place, and the graph's static outputs are consumed under the
scheduler lock before the next replay.  :meth:`GenerationScheduler.warmup`
makes the whole family (the power-of-two length and page ladders) before
traffic.

Telemetry and resilience follow the JAX package: each sequence keeps the
span context it was submitted under (``http.generate`` behind the HTTP
surface); the paged engine's forwards open ``serving.generation.prefill``
/ ``.decode`` spans under it; every forward passes the ``decode`` fault
site; with ``MXNET_TPU_HEALTH`` set the whole logits batch goes to the
host for :func:`~mxnet_tpu_torch.observability.health.check_logits`
(unset, only the sampled rows leave the device); the step loop counts
steps, tokens and cancellations as ``mxnet_tpu_serving_*`` metrics and
records each finished request in the serving goodput ledger as ``queue``
(submit to admission), ``execute`` (admission to retirement) and
``stream`` (retirement to resolution).

K/V moves between replicas as the JAX package's does: ``prefill_only``
(the prefill role's export) runs the ``[1, L]`` prefill and gathers the
prompt's K/V to the host as float32; ``export_request`` snapshots a live
request the same way without stopping it; ``submit(ext_kv=...)`` admits a
request whose prompt K/V was computed elsewhere, writing the slices into
the pool in place (no forward) under the same chain hashes.  A bfloat16
pool widens to float32 and narrows back exactly.
"""
from __future__ import annotations

import queue
import threading
import time
import uuid
import warnings
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..base import MXNetError, RequestCancelledError, env as _env, row_bucket
from ..cached_op import CachedOp
from ..observability import (goodput as _goodput, health as _health,
                             metrics as _metrics, tracing as _tracing)
from ..resilience import OverloadedError, maybe_fault
from .hostbuf import HostBufferPool
from .paged_cache import PagePool, page_hash_chain, pages_needed
from .stats import ServingStats

__all__ = ["GenerationScheduler", "TokenStream", "greedy_decode",
           "length_bucket", "DEFAULT_EOS"]


_REG = _metrics.registry()
_M_STEPS = _REG.counter(
    "mxnet_tpu_serving_decode_steps_total",
    "Scheduler decode iterations executed (one batched forward each, or "
    "one draft+verify round under speculation).", labels=("model",))
_M_TOKENS = _REG.counter(
    "mxnet_tpu_serving_decode_tokens_total",
    "Tokens emitted across all sequences.", labels=("model",))
_M_PROPOSED = _REG.counter(
    "mxnet_tpu_serving_spec_proposed_total",
    "Draft tokens proposed by the speculative decoder.", labels=("model",))
_M_ACCEPTED = _REG.counter(
    "mxnet_tpu_serving_spec_accepted_total",
    "Draft tokens accepted by target verification.", labels=("model",))
_M_CANCELLED = _REG.counter(
    "mxnet_tpu_serving_cancelled_total",
    "Requests cancelled mid-flight via GenerationScheduler.cancel (client "
    "disconnect, hedge loser, migration source); pages freed immediately.",
    labels=("model",))


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
    request's failure at the iteration site.  ``rid`` is the request id the
    HTTP layer cancels when its client disconnects."""

    __slots__ = ("_q", "rid")

    def __init__(self, rid: Optional[str] = None):
        self._q = queue.Queue()
        self.rid = rid

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


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _rows(logits: torch.Tensor, rows: Sequence[int], cols: Sequence[int]
          ) -> np.ndarray:
    """Host float32 copy of ``logits[rows[i], cols[i]]``, one row each:
    only the rows that are sampled leave the device."""
    dev = logits.device
    return logits[_index(rows, dev), _index(cols, dev)].float().cpu().numpy()


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
                 "pages", "dpages", "cached", "dcached", "prefix_pages",
                 "t_submit", "t_admit", "t_retire", "ctx", "stream",
                 "streamed", "rid", "ext_kv")

    def __init__(self, prompt, max_new, eos_id, stream=None, rid=None,
                 ext_kv=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.generated: List[int] = []
        self.future: Future = Future()
        # goodput marks: pending-queue wait, decode residency, delivery
        self.t_submit = time.monotonic()
        self.t_admit: Optional[float] = None
        self.t_retire: Optional[float] = None
        self.ctx = _tracing.current_context()  # http.generate root, if any
        self.pages: List[int] = []       # target page table (physical ids)
        self.dpages: List[int] = []      # draft page table
        self.cached = 0                  # valid target cache length
        self.dcached = 0                 # valid draft cache length
        self.prefix_pages = 0            # pages mapped from the prefix cache
        self.stream: Optional[TokenStream] = stream
        self.streamed = 0                # tokens already pushed to `stream`
        self.rid = rid
        self.ext_kv = ext_kv             # imported prompt K/V (host float32)

    @property
    def tokens(self) -> List[int]:
        return self.prompt + self.generated

    def done(self) -> bool:
        if len(self.generated) >= self.max_new:
            return True
        return (self.eos_id is not None and bool(self.generated)
                and self.generated[-1] == self.eos_id)


class _PagedLM:
    """One model's cached-decode surface: a page pool plus one
    :class:`CachedOp` over the model's ``cache_forward``.  Signatures are
    ``(B, C, P)`` (batch rows, chunk tokens, table pages), all on
    power-of-two ladders; the pools are read in place."""

    def __init__(self, model, pool: PagePool):
        self.model = model
        self.pool = pool
        self._op = CachedOp(model.cache_forward, model, in_place=2,
                            fresh_outputs=False)
        self._hb = HostBufferPool(owner=f"{pool.name}-tables")

    @torch.no_grad()
    def forward(self, tok: np.ndarray, pos: np.ndarray, lens: np.ndarray,
                tables: Sequence[Sequence[int]], page_bucket: int):
        """One chunk forward; returns device tensors (logits [B, C, V],
        k_new, v_new [layers, B, C, kv]), on the card the graph's static
        outputs, which the next call overwrites.  ``tables`` rows are
        padded with the scratch page to ``page_bucket`` columns."""
        b = tok.shape[0]
        table = self._hb.get((b, page_bucket), np.int64, tag="table")
        for i, row in enumerate(tables):
            if len(row):
                table[i, :len(row)] = row
        maybe_fault("decode")
        dev = self.pool.k.device
        out = self._op(_index(tok, dev), _index(pos, dev), _index(lens, dev),
                       _index(table, dev), self.pool.k, self.pool.v)
        if _health.serving_sentinel_enabled():
            _health.check_logits(f"decode:{self.pool.name}",
                                 out[0].float().cpu().numpy())
        return out

    @property
    def cache_stats(self):
        return self._op.cache_stats


def _page_bucket(n_pages: int) -> int:
    """Power-of-two page-table width (0 stays 0: the empty-window prefill)."""
    return 0 if n_pages <= 0 else row_bucket(n_pages, 1)


def _ladder(lo: int, hi: int) -> List[int]:
    """lo, 2 lo, 4 lo, ... below hi, then hi."""
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return sorted(set(out))


class GenerationScheduler:
    """Continuous batching over a token-in/logits-out decoder.

    ``model`` is an ``nn.Module`` mapping int64 tokens ``[B, S]`` on its
    device to logits ``[B, S, vocab]`` (the :class:`LlamaModel` contract).
    Requests enter via :meth:`submit`; :meth:`step` admits queued requests
    into free slots, advances every active sequence by one token (or one
    speculative round) and retires finished ones; :meth:`run` steps until
    idle.

    Engine selection: ``kv_cache=None`` uses the paged engine when the
    model has ``cache_forward`` and ``MXNET_SERVING_KV_CACHE`` is on, else
    the dense engine; ``True``/``False`` force it.  The page pool lives on
    the model's device in the model's dtype.  ``draft_model`` (a model
    with ``cache_forward`` and the same vocabulary) with ``spec_tokens`` /
    ``MXNET_SERVING_SPEC_TOKENS`` > 0 turns on speculative decoding on the
    paged engine; its pool lives on its own device in its own dtype.
    """

    def __init__(self, model, max_slots: int = 4, eos_id: Optional[int] = None,
                 min_bucket: int = 16, max_length: Optional[int] = None,
                 kv_cache: Optional[bool] = None,
                 page_tokens: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 draft_model=None, spec_tokens: Optional[int] = None,
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
        self._m_steps = _M_STEPS.labels(model=self.name)
        self._m_tokens = _M_TOKENS.labels(model=self.name)
        self.logit_rows = 0     # logits rows copied to the host and sampled
        self.nonfinite_rows = 0  # of those, rows holding a NaN or Inf
        self._hb = HostBufferPool(owner=self.name)
        self.spec_tokens = 0
        self._draft: Optional[_PagedLM] = None

        if kv_cache is None:
            kv_cache = (bool(_env.MXNET_SERVING_KV_CACHE)
                        and hasattr(model, "cache_forward"))
        elif kv_cache and not hasattr(model, "cache_forward"):
            raise MXNetError(
                f"kv_cache=True but {type(model).__name__} has no "
                "cache_forward; pass kv_cache=False for the dense path")
        self.paged = bool(kv_cache)

        if not self.paged:
            self._op = CachedOp(model.forward, model, fresh_outputs=False)
            return
        self.page_tokens = int(page_tokens or _env.MXNET_SERVING_PAGE_TOKENS)
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
        if draft_model is not None:
            self.spec_tokens = int(_env.MXNET_SERVING_SPEC_TOKENS
                                   if spec_tokens is None else spec_tokens)
        if self.spec_tokens > 0:
            if not hasattr(draft_model, "cache_forward"):
                raise MXNetError("draft_model needs cache_forward")
            dl, dkv, dmax = draft_model.kv_cache_spec()
            if self.max_length > dmax:
                raise MXNetError(
                    f"max_length {self.max_length} exceeds the draft "
                    f"model's RoPE table ({dmax})")
            # the draft's cache runs a few speculative tokens ahead
            dpages = int(num_pages or _env.MXNET_SERVING_KV_PAGES)
            if not dpages:
                dpages = 1 + self.max_slots * pages_needed(
                    self.max_length + self.spec_tokens, self.page_tokens)
            self._draft = _PagedLM(draft_model, PagePool(
                dl, dpages, self.page_tokens, dkv, name=f"{self.name}-draft",
                prefix_cache=False, dtype=next(draft_model.parameters()).dtype,
                device=_model_device(draft_model)))
            self._m_proposed = _M_PROPOSED.labels(model=self.name)
            self._m_accepted = _M_ACCEPTED.labels(model=self.name)

    # ------------------------------------------------------------- intake
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Union[Optional[int], _DefaultEos] = DEFAULT_EOS,
               stream: Optional[TokenStream] = None,
               ext_kv: Optional[dict] = None,
               rid: Optional[str] = None) -> Future:
        """Queue a prompt; the Future resolves to the generated token list.

        ``eos_id`` defaults to the scheduler's own; pass ``None`` to disable
        eos for this request.  Rejects up front anything that could outgrow
        ``max_length`` (or either page pool) mid-decode.  ``stream``
        receives every token as it is produced; ``rid`` names the request
        for :meth:`cancel` and :meth:`export_request` (assigned when
        omitted).

        ``ext_kv`` is the disaggregation import: ``{"k": [layers, m,
        kv_units] float32, "v": ..., "first_token": int}`` from a prefill
        replica's export (or a migration snapshot).  Admission then writes
        the imported slices instead of running the prefill forward, and
        decode continues from the shipped first token."""
        if not len(prompt):
            raise MXNetError("empty prompt")
        if ext_kv is not None:
            if not self.paged:
                raise MXNetError("ext_kv import needs the paged engine")
            pool = self._target.pool
            want = (pool.num_layers, len(prompt), pool.kv_units)
            for key in ("k", "v"):
                arr = ext_kv.get(key)
                if arr is None or tuple(getattr(arr, "shape", ())) != want:
                    raise MXNetError(
                        f"ext_kv[{key!r}] must be shaped {want} "
                        f"(layers, prompt_tokens, kv_units), got "
                        f"{getattr(arr, 'shape', None)}")
            if "first_token" not in ext_kv:
                raise MXNetError("ext_kv needs the prefill replica's "
                                 "'first_token'")
        if (self.max_length is not None
                and len(prompt) + int(max_new_tokens) > self.max_length):
            raise MXNetError(
                f"prompt of {len(prompt)} tokens + max_new_tokens "
                f"{max_new_tokens} exceeds max_length {self.max_length}")
        if self.paged:
            total = len(prompt) + int(max_new_tokens)
            need = pages_needed(total, self.page_tokens)
            cap = self._target.pool.num_pages - 1
            if need > cap:
                raise MXNetError(
                    f"request needs {need} KV pages but the pool only has "
                    f"{cap}; raise MXNET_SERVING_KV_PAGES or num_pages")
            if self._draft is not None:
                dcap = self._draft.pool.num_pages - 1
                dneed = pages_needed(total + self.spec_tokens,
                                     self.page_tokens)
                if dneed > dcap:
                    raise MXNetError(
                        f"request needs {dneed} DRAFT KV pages (budget + "
                        f"{self.spec_tokens} speculative) but the draft "
                        f"pool only has {dcap}; an accepted-but-never-"
                        "admissible request would wedge the step loop")
        seq = _Sequence(prompt, max_new_tokens,
                        self.eos_id if eos_id is DEFAULT_EOS else eos_id,
                        stream=stream, ext_kv=ext_kv,
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
        active slot), freeing its KV pages (target and draft) at once and
        failing its Future and stream with :class:`RequestCancelledError`.
        Returns False when the rid is unknown or already finished."""
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
            self._free_pages(seq)
            self.cancelled += 1
        _M_CANCELLED.labels(model=self.name).inc()
        exc = RequestCancelledError(
            f"{self.name}: request {rid} cancelled "
            f"({len(seq.generated)} tokens generated)")
        if seq.stream is not None:
            seq.stream._fail(exc)
        if not seq.future.done():
            seq.future.set_exception(exc)
        return True

    def export_request(self, rid: str) -> dict:
        """Live-migration snapshot of the in-flight request ``rid``: its
        prompt, the tokens generated so far, the sampling mode (greedy:
        there is no random state to ship) and, on the paged engine once the
        request holds pages, the host float32 K/V covering ``tokens[:-1]``
        (every position but the last sampled token, which the importer
        seeds as ``ext_kv["first_token"]``) with its chain hashes.  A
        survivor resumes with ``submit(prompt + generated[:-1],
        ext_kv={"k", "v", "first_token": generated[-1]})``.  A read under
        the scheduler lock: the request goes on."""
        with _goodput.serving().owned(), self._lock:
            seq = self._rids.get(str(rid))
            if seq is None:
                raise MXNetError(f"{self.name}: unknown request id {rid!r}")
            gen = list(seq.generated)
            out = {"rid": seq.rid, "prompt": list(seq.prompt),
                   "generated": gen, "max_new_tokens": seq.max_new,
                   "eos_id": seq.eos_id, "sampling": "greedy"}
            if self.paged and seq.pages and gen \
                    and seq.cached >= len(seq.prompt):
                # the K/V must cover exactly prompt + generated[:-1],
                # whichever of the two views is older
                n = min(seq.cached, len(seq.prompt) + len(gen) - 1)
                gen = gen[:n - len(seq.prompt) + 1]
                out["generated"] = gen
                pool = self._target.pool
                where = [pool.locate(seq.pages, p) for p in range(n)]
                out["k"], out["v"] = pool.gather([p for p, _ in where],
                                                 [o for _, o in where])
                out["hashes"] = page_hash_chain(seq.tokens[:n],
                                                self.page_tokens)
                out["page_tokens"] = self.page_tokens
            return out

    # ------------------------------------------------------------- sampling
    def _sample(self, logits: torch.Tensor, rows: Sequence[int],
                cols: Sequence[int]) -> List[int]:
        """Greedy tokens at ``logits[rows[i], cols[i]]``, rows copied to the
        host; counts them and the ones that hold a non-finite value."""
        host = _rows(logits, rows, cols)
        self.logit_rows += len(host)
        self.nonfinite_rows += int((~np.isfinite(host).all(axis=1)).sum())
        return [_next_token(r) for r in host]

    def _count_tokens(self, n: int) -> None:
        self._m_tokens.inc(n)

    # ------------------------------------------------------------- dense
    @torch.no_grad()
    def _forward(self, tokens_np: np.ndarray) -> torch.Tensor:
        maybe_fault("decode")
        out = self._op(torch.from_numpy(tokens_np).to(self._device))
        if _health.serving_sentinel_enabled():
            _health.check_logits("decode:dense", out.float().cpu().numpy())
        return out

    def _prefill_dense(self, seq: _Sequence) -> None:
        L = length_bucket(len(seq.prompt), self.min_bucket, self.max_length)
        arr = self._hb.get((1, L), np.int64, tag="prefill")
        arr[0, :len(seq.prompt)] = seq.prompt
        seq.generated.extend(self._sample(self._forward(arr), [0],
                                          [len(seq.prompt) - 1]))
        self._count_tokens(1)

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
        self._count_tokens(len(active))
        return L

    # ------------------------------------------------------------- paged
    def _admission_ok(self, seq: _Sequence) -> bool:
        """Page-governed admission: map the prompt's cached prefix, then
        reserve the worst-case page need (and the draft's) up front so the
        step loop can never strand a half-grown sequence."""
        pool = self._target.pool
        m = len(seq.prompt)
        total = m + seq.max_new
        hashes = page_hash_chain(seq.prompt, self.page_tokens)
        # share only complete pages strictly before the last prompt token:
        # the final token always runs through prefill for its logits
        shareable = min(len(hashes), (m - 1) // self.page_tokens)
        shared = pool.match_prefix(hashes[:shareable])
        own = pages_needed(total, self.page_tokens) - len(shared)
        dneed = 0
        if self._draft is not None:
            dneed = pages_needed(total + self.spec_tokens, self.page_tokens)
        if pool.available() < own or (
                self._draft is not None
                and self._draft.pool.available() < dneed):
            pool.release(shared)
            return False
        seq.pages = shared + pool.allocate(own)
        seq.prefix_pages = len(shared)
        if self._draft is not None:
            seq.dpages = self._draft.pool.allocate(dneed)
        return True

    def _free_pages(self, seq: _Sequence) -> None:
        if seq.pages:
            self._target.pool.release(seq.pages)
            seq.pages = []
        if seq.dpages:
            self._draft.pool.release(seq.dpages)
            seq.dpages = []

    def _prefill_paged(self, seq: _Sequence) -> None:
        pool = self._target.pool
        m = len(seq.prompt)
        c = seq.prefix_pages * self.page_tokens   # tokens already cached
        suffix = seq.prompt[c:]
        L = length_bucket(len(suffix), self.min_bucket, self.max_length)
        tok = self._hb.get((1, L), np.int64, tag="prefill")
        tok[0, :len(suffix)] = suffix
        with _tracing.span("serving.generation.prefill",
                           attrs={"model": self.name, "tokens": len(suffix),
                                  "prefix_hit_tokens": c},
                           parent=seq.ctx):
            logits, k_new, v_new = self._target.forward(
                tok, np.array([c]), np.array([c]),
                [seq.pages[:seq.prefix_pages]],
                _page_bucket(seq.prefix_pages))
        # write the suffix K/V (positions c .. m-1) into this request's pages
        where = [pool.locate(seq.pages, p) for p in range(c, m)]
        pool.write(k_new[:, 0, :len(suffix)], v_new[:, 0, :len(suffix)],
                   [p for p, _ in where], [o for _, o in where])
        seq.cached = m
        # register the freshly completed prompt pages for later prefix hits
        for j, hsh in enumerate(page_hash_chain(seq.prompt, self.page_tokens)):
            pool.register(seq.pages[j], hsh)
        seq.generated.extend(self._sample(logits, [0], [len(suffix) - 1]))
        self._count_tokens(1)
        if self._draft is not None and seq.dpages:
            self._prefill_draft(seq)

    def _prefill_external(self, seq: _Sequence) -> None:
        """Disaggregation import: admit a sequence whose prompt K/V was
        computed on another replica.  Writes the shipped slices into this
        pool in place (skipping pages already mapped from the local prefix
        cache: identical content by chain-hash construction), registers
        the same chain hashes, and seeds the stream with the shipped first
        token.  No target forward runs, so a decode replica's family stays
        the ``[slots, 1]`` decode ladder (the draft's prompt prefill runs
        locally)."""
        pool = self._target.pool
        m = len(seq.prompt)
        c = seq.prefix_pages * self.page_tokens   # locally shared tokens
        with _tracing.span("serving.generation.import_kv",
                           attrs={"model": self.name, "tokens": m - c,
                                  "prefix_hit_tokens": c},
                           parent=seq.ctx):
            if m > c:
                dev = pool.k.device
                with warnings.catch_warnings():
                    # a decoded handoff is a read-only buffer; it is only
                    # read, copied to the pool's device
                    warnings.simplefilter("ignore", UserWarning)
                    k, v = (torch.from_numpy(np.ascontiguousarray(
                        seq.ext_kv[key][:, c:m], dtype=np.float32)).to(dev)
                        for key in ("k", "v"))
                where = [pool.locate(seq.pages, p) for p in range(c, m)]
                pool.write(k, v, [p for p, _ in where],
                           [o for _, o in where])
        seq.cached = m
        for j, hsh in enumerate(page_hash_chain(seq.prompt, self.page_tokens)):
            pool.register(seq.pages[j], hsh)
        seq.generated.append(int(seq.ext_kv["first_token"]))
        self._count_tokens(1)
        seq.ext_kv = None  # drop the host copy once it has landed
        if self._draft is not None and seq.dpages:
            self._prefill_draft(seq)

    @torch.no_grad()
    def prefill_only(self, prompt: Sequence[int],
                     max_new_tokens: int = 16) -> dict:
        """Disaggregation export (the prefill role's surface): run the
        prompt's ``[1, L]`` prefill, then return its first token, the host
        float32 K/V of every prompt position and the chain hashes: what a
        decode replica needs to admit the request with ``submit(...,
        ext_kv=...)``.  The prompt's pages are released after the gather
        (complete registered pages park in the prefix cache, so repeated
        system prompts stay warm here too); no decode slot is held.
        Raises :class:`OverloadedError` with ``retry_after_s`` when the
        pool has no pages for the prompt."""
        if not self.paged:
            raise MXNetError("prefill_only needs the paged engine")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("empty prompt")
        if (self.max_length is not None
                and len(prompt) + int(max_new_tokens) > self.max_length):
            raise MXNetError(
                f"prompt of {len(prompt)} tokens + max_new_tokens "
                f"{max_new_tokens} exceeds max_length {self.max_length}")
        m = len(prompt)
        hashes = page_hash_chain(prompt, self.page_tokens)
        with _goodput.serving().owned(), self._lock:
            pool = self._target.pool
            seq = _Sequence(prompt, max_new_tokens, None)
            shareable = min(len(hashes), (m - 1) // self.page_tokens)
            shared = pool.match_prefix(hashes[:shareable])
            own = pages_needed(m, self.page_tokens) - len(shared)
            if pool.available() < own:
                pool.release(shared)
                raise OverloadedError(
                    f"{self.name}: no free KV pages for prefill "
                    f"(need {own}, have {pool.available()})",
                    retry_after_s=0.5)
            seq.pages = shared + pool.allocate(own)
            seq.prefix_pages = len(shared)
            try:
                self._prefill_paged(seq)
                where = [pool.locate(seq.pages, p) for p in range(m)]
                k, v = pool.gather([p for p, _ in where],
                                   [o for _, o in where])
            finally:
                self._free_pages(seq)
        return {"first_token": seq.generated[0], "k": k, "v": v,
                "hashes": hashes, "page_tokens": self.page_tokens}

    def _prefill_draft(self, seq: _Sequence) -> None:
        """Prime the draft cache with the prompt at admission (no prefix
        sharing: the draft is cheap).  The draft stays exactly one token
        behind the confirmed sequence, so every later draft chunk is 1 or
        2 tokens wide and mixed fresh and mid-flight batches mint no new
        shapes."""
        draft = self._draft
        m = len(seq.prompt)
        L = length_bucket(m, self.min_bucket, self.max_length)
        tok = self._hb.get((1, L), np.int64, tag="dprefill")
        tok[0, :m] = seq.prompt
        zero1 = self._hb.get((1,), np.int64, tag="dprefill0")
        _, k_new, v_new = draft.forward(tok, zero1, zero1, [[]], 0)
        where = [draft.pool.locate(seq.dpages, p) for p in range(m)]
        draft.pool.write(k_new[:, 0, :m], v_new[:, 0, :m],
                         [p for p, _ in where], [o for _, o in where])
        seq.dcached = m

    def _table(self, seq: _Sequence, draft: bool = False) -> List[int]:
        cached = seq.dcached if draft else seq.cached
        pages = seq.dpages if draft else seq.pages
        return pages[:pages_needed(cached, self.page_tokens)]

    def _write_rows(self, lm: _PagedLM, k_new, v_new, rows, cols, where):
        """K/V of chunk entries ``(rows[i], cols[i])`` into ``lm``'s pool at
        ``where[i]`` (page id, offset)."""
        if where:
            r, c = _index(rows, k_new.device), _index(cols, k_new.device)
            lm.pool.write(k_new[:, r, c], v_new[:, r, c],
                          [p for p, _ in where], [o for _, o in where])

    def _decode_paged(self, active) -> None:
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
            tables[i] = self._table(s)
        pb = _page_bucket(max(len(t) for t in tables))
        # one batched step: the span goes to the oldest active request's
        # trace (one causal chain per request would need span links)
        parent = next((s.ctx for _, s in active if s.ctx is not None), None)
        with _tracing.span("serving.generation.decode",
                           attrs={"model": self.name, "slots": len(active),
                                  "page_bucket": pb},
                           parent=parent):
            logits, k_new, v_new = self._target.forward(tok, pos, lens,
                                                        tables, pb)
        self._write_rows(self._target, k_new, v_new,
                         [i for i, _ in active], [0] * len(active),
                         [pool.locate(s.pages, s.cached) for _, s in active])
        toks = self._sample(logits, [i for i, _ in active], [0] * len(active))
        for (_, s), t in zip(active, toks):
            s.cached += 1
            s.generated.append(t)
        self._count_tokens(len(active))

    def _spec_round(self, active) -> None:
        """The draft proposes ``spec_tokens``, the target verifies them in
        one batched forward, greedy accept/rollback: token-identical to
        target-only greedy decode.  Rollback is free: rejected positions
        were never written inside the valid cache length, and the draft's
        overrun truncates by clamping its cached length."""
        spec = self.spec_tokens
        draft, pool = self._draft, self._target.pool
        b = self.max_slots
        slots = [i for i, _ in active]
        proposals: List[List[int]] = [[] for _ in range(b)]
        # --- draft proposal rounds (the first folds in any catch-up) ----
        with _tracing.span("serving.generation.draft",
                           attrs={"model": self.name, "spec": spec}):
            for j in range(spec):
                chunks: List[List[int]] = [[] for _ in range(b)]
                for i, s in active:
                    chunks[i] = ([proposals[i][-1]] if j else
                                 s.tokens[s.dcached:])
                cb = row_bucket(max(len(ch) for ch in chunks), 1)
                tok = self._hb.get((b, cb), np.int64, tag="tok")
                pos = self._hb.get((b,), np.int64, tag="pos")
                lens = self._hb.get((b,), np.int64, tag="len")
                tables: List[List[int]] = [[] for _ in range(b)]
                for i, s in active:
                    tok[i, :len(chunks[i])] = chunks[i]
                    pos[i] = lens[i] = s.dcached
                    tables[i] = self._table(s, draft=True)
                pb = _page_bucket(max(len(t) for t in tables))
                logits, k_new, v_new = draft.forward(tok, pos, lens,
                                                     tables, pb)
                rows, cols, where = [], [], []
                for i, s in active:
                    for r in range(len(chunks[i])):
                        rows.append(i)
                        cols.append(r)
                        where.append(draft.pool.locate(s.dpages,
                                                       s.dcached + r))
                self._write_rows(draft, k_new, v_new, rows, cols, where)
                picks = self._sample(logits, slots,
                                     [len(chunks[i]) - 1 for i in slots])
                for (i, s), t in zip(active, picks):
                    s.dcached += len(chunks[i])
                    proposals[i].append(t)
        # --- target verify: [slots, spec+1] over the paged cache ---------
        tok = self._hb.get((b, spec + 1), np.int64, tag="tok")
        pos = self._hb.get((b,), np.int64, tag="pos")
        lens = self._hb.get((b,), np.int64, tag="len")
        tables = [[] for _ in range(b)]
        for i, s in active:
            tok[i, 0] = s.tokens[-1]
            tok[i, 1:] = proposals[i]
            pos[i] = lens[i] = s.cached
            tables[i] = self._table(s)
        pb = _page_bucket(max(len(t) for t in tables))
        with _tracing.span("serving.generation.verify",
                           attrs={"model": self.name, "slots": len(active),
                                  "spec": spec}):
            logits, k_new, v_new = self._target.forward(tok, pos, lens,
                                                        tables, pb)
        greedy = self._sample(logits, [i for i in slots
                                       for _ in range(spec + 1)],
                              list(range(spec + 1)) * len(slots))
        # --- greedy accept / rollback per slot ---------------------------
        rows, cols, where = [], [], []
        accepted_total = 0
        for n, (i, s) in enumerate(active):
            g = greedy[n * (spec + 1):(n + 1) * (spec + 1)]
            a = 0
            while a < spec and proposals[i][a] == g[a]:
                a += 1
            accepted_total += a
            new_tokens = proposals[i][:a] + [g[a]]
            new_tokens = new_tokens[:s.max_new - len(s.generated)]
            if s.eos_id is not None and s.eos_id in new_tokens:
                new_tokens = new_tokens[:new_tokens.index(s.eos_id) + 1]
            # rows 0..n_new-1 fed (last, d1..d_{n_new-1}), all confirmed
            # tokens, so their K/V land at cached..cached+n_new-1
            for r in range(len(new_tokens)):
                rows.append(i)
                cols.append(r)
                where.append(pool.locate(s.pages, s.cached + r))
            s.cached += len(new_tokens)
            s.generated.extend(new_tokens)
            self._count_tokens(len(new_tokens))
            # draft rollback: clamp to the confirmed sequence (stale
            # entries past the clamp are masked by dcached, never read)
            s.dcached = min(s.dcached, len(s.tokens) - 1)
        self._write_rows(self._target, k_new, v_new, rows, cols, where)
        self._m_proposed.inc(spec * len(active))
        self._m_accepted.inc(accepted_total)

    # ------------------------------------------------------------- stepping
    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: admit, decode one token (or one
        speculative round) for every active sequence, retire.  Returns
        True while any work remains."""
        finished: List[_Sequence] = []
        failed: List = []  # (sequence, exception): fault isolation per step
        # serving-owned: the forwards belong to request-time attribution
        with _goodput.serving().owned(), self._lock:
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
                        self._free_pages(seq)
                        self._rids.pop(seq.rid, None)
                        continue
                    seq.t_admit = time.monotonic()  # the queue wait ends
                    try:
                        if self.paged and seq.ext_kv is not None:
                            self._prefill_external(seq)
                        elif self.paged:
                            self._prefill_paged(seq)
                        else:
                            self._prefill_dense(seq)
                    except Exception as e:  # noqa: BLE001 — fail THIS future
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
                    if not self.paged:
                        L = self._decode_dense(active)
                    else:
                        if self._draft is not None:
                            self._spec_round(active)
                        else:
                            self._decode_paged(active)
                        L = max(len(s.tokens) for _, s in active)
                    for i, s in active:
                        if s.done():
                            self._retire(i, s, finished)
                    self.steps += 1
                    self._m_steps.inc()
                    self._stats.record_batch(len(active), len(active), L)
                except Exception as e:  # noqa: BLE001 — a decode fault fails
                    # every in-flight sequence instead of wedging its future
                    for i, s in active:
                        self._slots[i] = None
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
            t_res = time.monotonic()
            t_admit = seq.t_admit if seq.t_admit is not None else seq.t_submit
            t_retire = seq.t_retire if seq.t_retire is not None else t_res
            tid = seq.ctx.trace_id if seq.ctx is not None else None
            # the latency histogram first: the retention percentile of the
            # goodput offer below is computed from it
            self._stats.record_request((t_res - seq.t_submit) * 1e6,
                                       trace_id=tid)
            _goodput.serving().record_request(
                self.name, t_res - seq.t_submit,
                {"queue": t_admit - seq.t_submit,
                 "execute": t_retire - t_admit,
                 "stream": t_res - t_retire},
                trace_id=tid, attrs={"tokens": len(seq.generated)})
        for seq, e in failed:
            if seq.ctx is not None:  # a failed trace: drop its spans
                _tracing.discard_trace(seq.ctx.trace_id)
            if seq.stream is not None:
                seq.stream._fail(e)
            if not seq.future.done():
                seq.future.set_exception(e)
        return more

    def _retire(self, slot: int, seq: _Sequence, finished: List[_Sequence],
                occupied: bool = True):
        seq.t_retire = time.monotonic()
        if occupied:
            self._slots[slot] = None
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

    # ------------------------------------------------------------- warmup
    @torch.no_grad()
    def warmup(self, max_prompt_len: Optional[int] = None,
               max_new_tokens: int = 16, role: str = "mixed") -> int:
        """Make every signature live traffic can reach before its first
        token (on the card: run and capture each CUDA graph): the prefill
        chunk ladder up to ``max_prompt_len``, against an empty page table
        and the prefix-hit page ladder; the decode page ladder up to
        ``max_prompt_len + max_new_tokens``; under speculation the verify
        ladder and the draft's prefill and 1- and 2-token chunk ladders.
        The dense engine makes ``(1, L)`` and ``(slots, L)`` over its length
        ladder.  Within each family the largest signature comes first, so
        the rest capture into its graph pool.  Returns the entries made.

        ``role`` restricts the family to what a disaggregated replica can
        reach: ``"prefill"`` the ``[1, L]`` chunk ladder only,
        ``"decode"`` the ``[slots, 1]`` ladder plus the draft and verify
        families (the draft's prompt prefill runs locally)."""
        # serving-owned: the warm forwards stay out of the train ledger;
        # the lock keeps the step loop off the graphs' static outputs
        with _goodput.serving().owned(), self._lock:
            return self._warmup(max_prompt_len, max_new_tokens, role)

    def _entries(self) -> int:
        n = self.cache_stats["entries"]
        if self._draft is not None:
            n += self._draft.cache_stats["entries"]
        return n

    def _warmup(self, max_prompt_len, max_new_tokens, role) -> int:
        if role not in ("mixed", "prefill", "decode"):
            raise MXNetError(f"unknown warmup role {role!r}; expected "
                             "'mixed', 'prefill' or 'decode'")
        if max_prompt_len is None:
            max_prompt_len = self.max_length or 4 * self.min_bucket
        total = max_prompt_len + int(max_new_tokens)
        if self.max_length is not None:
            total = min(total, self.max_length)
        before = self._entries()
        if not self.paged:
            top = length_bucket(total, self.min_bucket, self.max_length)
            for L in reversed(_ladder(self.min_bucket, top)):
                for bsz in (self.max_slots, 1):
                    self._forward(np.zeros((bsz, L), dtype=np.int64))
            return self._entries() - before

        zeros = lambda *s: np.zeros(s, dtype=np.int64)
        slots = self.max_slots
        prefill_top = length_bucket(max_prompt_len, self.min_bucket,
                                    self.max_length)
        chunk_ladder = _ladder(self.min_bucket, prefill_top)[::-1]
        pb_ladder = _ladder(1, _page_bucket(pages_needed(
            total, self.page_tokens)))[::-1]
        # a prefix-hit suffix prefill runs [1, L] against a non-empty table
        # (the shared prefix's page bucket): the prefill family is the chunk
        # ladder times {empty} and the page ladder up to the largest
        # shareable prefix
        prefix_top = _page_bucket((max_prompt_len - 1) // self.page_tokens)
        prefill_pbs = ((_ladder(1, prefix_top)[::-1]
                        if self._target.pool.prefix_cache_enabled
                        and prefix_top else []) + [0])
        if role in ("mixed", "prefill"):
            for L in chunk_ladder:
                for pb in prefill_pbs:
                    self._target.forward(zeros(1, L), zeros(1), zeros(1),
                                         [[0] * pb], pb)
        if role in ("mixed", "decode"):
            for width in ([self.spec_tokens + 1] if self._draft else []) + [1]:
                for pb in pb_ladder:
                    self._target.forward(zeros(slots, width), zeros(slots),
                                         zeros(slots), [[0] * pb] * slots, pb)
        if self._draft is not None and role in ("mixed", "decode"):
            # the draft shapes live traffic makes: the [1, L] prompt prefill
            # at admission, then 1- and 2-token proposal chunks (_prefill_
            # draft keeps the draft one token behind, so none is wider)
            for L in chunk_ladder:
                self._draft.forward(zeros(1, L), zeros(1), zeros(1), [[]], 0)
            dpb_ladder = _ladder(1, _page_bucket(pages_needed(
                total + self.spec_tokens, self.page_tokens)))[::-1]
            for cb in (2, 1):
                for pb in dpb_ladder:
                    self._draft.forward(zeros(slots, cb), zeros(slots),
                                        zeros(slots), [[0] * pb] * slots, pb)
        return self._entries() - before

    # ------------------------------------------------------------- stats
    @property
    def cache_stats(self):
        """The target's (or the dense engine's) CachedOp counters."""
        return (self._target.cache_stats if self.paged
                else self._op.cache_stats)

    def stats_snapshot(self):
        snap = {"steps": self.steps, "admitted": self.admitted,
                "retired": self.retired, "cancelled": self.cancelled,
                "pending": len(self._pending),
                "active": sum(s is not None for s in self._slots),
                "engine": "paged" if self.paged else "dense",
                "logit_rows": self.logit_rows,
                "nonfinite_rows": self.nonfinite_rows}
        snap["compile_cache"] = {k: v for k, v in self.cache_stats.items()
                                 if k != "signatures"}
        if self.paged:
            snap["page_pool"] = self._target.pool.stats()
            if self._draft is not None:
                snap["spec_tokens"] = self.spec_tokens
                snap["draft_page_pool"] = self._draft.pool.stats()
                proposed = self._m_proposed.value
                snap["spec_acceptance"] = (
                    self._m_accepted.value / proposed if proposed else 0.0)
        return snap
