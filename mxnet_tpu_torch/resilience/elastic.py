"""Elastic training, the checkpoint half (counterpart of
``mxnet_tpu/resilience/elastic.py``).

* :class:`AsyncCheckpointer` — every ``MXNET_TPU_ELASTIC_CKPT_STEPS``
  steps, ``save(step)`` takes **device copies** of the training step's
  state (parameters, the net's other tensors, optimizer states; the
  :class:`~mxnet_tpu_torch.checkpoint.TrainStepCheckpoint` layout) on a
  side stream and records an event; the train stream waits for the copies
  (the next step writes the originals in place), never for the write.  A
  daemon worker thread waits on the event, drains the copies to host
  memory on the same side stream, writes them to a ``.tmp-`` directory
  with ``meta.json`` (the step count, the optimizer's counts and the
  state of every random stream the step's graphs register) and the
  integrity manifest, and publishes the directory with one ``os.replace``.
  A torn write is never loadable.  A cadence point that arrives while the
  previous write is in flight waits for it (the wait is the train goodput
  ledger's ``checkpoint`` bucket), so a crash loses at most one window.
* :func:`latest_checkpoint` / :func:`load_elastic_checkpoint` — the
  newest durable ``step-NNNNNNNN`` directory, and its restore into a step
  (in place, so the step's graphs replay without a new capture) with its
  random streams and the optimizer's counts.

:class:`ElasticTrainStep`, which reforms the mesh on rank loss, rebuilds a
data-parallel mesh on the surviving ranks; it is not ported yet (ROADMAP
A11b), so it raises :class:`MXNetError` naming that item.
Its configuration (``ElasticConfig``, the reformation budget and the
smallest world) and its rank-loss classifier come with it.

Metrics: ``mxnet_tpu_elastic_*`` (checkpoints, write and wait seconds,
queue depth, last checkpoint step and time; the reformation counters and
the world size come with ElasticTrainStep); span ``elastic.checkpoint``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..base import MXNetError, env
from ..observability import metrics as _metrics, tracing as _tracing

__all__ = ["AsyncCheckpointer", "ElasticTrainStep", "latest_checkpoint",
           "load_elastic_checkpoint"]

_M_CKPTS = _metrics.registry().counter(
    "mxnet_tpu_elastic_checkpoints_total",
    "Async elastic checkpoints made durable (manifest published).")
_M_CKPT_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_elastic_checkpoint_seconds",
    "Worker-thread wall time of one async checkpoint write (device->host "
    "drain + file write + manifest + atomic publish) — never on the train "
    "step's critical path.")
_M_CKPT_WAIT_SECONDS = _metrics.registry().histogram(
    "mxnet_tpu_elastic_checkpoint_wait_seconds",
    "Train-thread time spent waiting for the previous in-flight checkpoint "
    "write at a cadence point (the backpressure that bounds crash loss to "
    "one cadence window; ~0 when writes keep up).")
_M_QUEUE = _metrics.registry().gauge(
    "mxnet_tpu_elastic_checkpoint_queue_depth",
    "Async checkpoint snapshots captured but not yet durable (0 or 1: "
    "cadence points apply backpressure instead of queueing unboundedly).")
_M_LAST_STEP = _metrics.registry().gauge(
    "mxnet_tpu_elastic_last_checkpoint_step",
    "Step counter of the last durable elastic checkpoint.")
_M_LAST_TIME = _metrics.registry().gauge(
    "mxnet_tpu_elastic_last_checkpoint_unixtime",
    "Unix time the last elastic checkpoint became durable.")


# ---------------------------------------------------------------------------
# format: <dir>/step-NNNNNNNN/ (the TrainStepCheckpoint layout + meta.json +
# integrity manifest), published by an atomic rename
# ---------------------------------------------------------------------------
def _step_dirname(step: int) -> str:
    return f"step-{step:08d}"


def latest_checkpoint(directory: str) -> Optional[Tuple[str, int]]:
    """``(path, step)`` of the newest DURABLE checkpoint under `directory`
    — one whose integrity manifest exists and verifies.  Torn writes
    (``.tmp-*`` working dirs, manifest-less or corrupt trees) are skipped:
    recovery only ever lands on a complete snapshot."""
    from ..checkpoint import verify_manifest
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step-"):
            try:
                steps.append((int(name.split("-", 1)[1]), name))
            except ValueError:
                continue
    for step, name in sorted(steps, reverse=True):
        path = os.path.join(directory, name)
        try:
            if verify_manifest(path, required=True):
                return path, step
        except Exception:  # noqa: BLE001 - torn/corrupt: try older ones
            continue
    return None


# one copy stream per device, its own: the graphs' side stream is captured
# on by the train thread, where this one's worker-thread drains must not go
_side_streams: Dict[int, Any] = {}


def _copy_stream(device: torch.device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    s = _side_streams.get(idx)
    if s is None:
        s = _side_streams[idx] = torch.cuda.Stream(device=idx)
    return s


def _capture_tree(step):
    """``(tree, ready)``: device copies of the step's state in the
    ``TrainStepCheckpoint`` layout (the one definition of it).  On the
    card the copies run on a side stream after the work already queued,
    the current stream waits for them (the next step writes the originals
    in place), and ``ready`` is the event that marks them done; elsewhere
    ``ready`` is None."""
    from ..checkpoint import TrainStepCheckpoint
    ck = TrainStepCheckpoint(step)
    dev = step._learnable[0].device
    if dev.type != "cuda":
        with torch.no_grad():
            return ck._state_tree(leaf_map=lambda t: t.detach().clone()), None
    side = _copy_stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    with torch.no_grad(), torch.cuda.stream(side):
        tree = ck._state_tree(leaf_map=lambda t: t.detach().clone())
        ready = torch.cuda.Event()
        ready.record(side)
    cur.wait_stream(side)
    return tree, ready


def _generators(step) -> List[torch.Generator]:
    from ..cached_op import generators_of
    return generators_of(step._net, step._learnable[0].device)


def _capture_meta(step) -> dict:
    opt = step._opt
    return {
        "step": int(step._num_update),
        "time_unix": time.time(),
        # the port's random streams in place of the JAX package's rng_key
        "rng_states": [g.get_state().tolist() for g in _generators(step)],
        "opt_num_update": int(opt.num_update),
        "opt_counts": [[k, int(v)] for k, v in opt._index_update_count.items()],
        "world_dp": 1,
    }


def load_elastic_checkpoint(path: str, step) -> dict:
    """Restore one durable elastic checkpoint into `step` (in place), plus
    the meta sidecar's random streams and optimizer counts.  Returns the
    meta dict.  The manifest is required: a torn write never loads."""
    from ..checkpoint import (CheckpointCorruptError, TrainStepCheckpoint,
                              verify_manifest)
    verify_manifest(path, required=True)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"elastic checkpoint meta {os.path.join(path, 'meta.json')} is "
            f"unreadable: {e}") from e
    # verify=False: the required verify above already hashed every file
    TrainStepCheckpoint(step).restore(path, verify=False)
    gens = _generators(step)
    states = meta.get("rng_states", [])
    if len(states) != len(gens):
        raise MXNetError(
            f"elastic checkpoint {path} holds {len(states)} random streams; "
            f"the step's graphs register {len(gens)}")
    for g, st in zip(gens, states):
        g.set_state(torch.tensor(st, dtype=torch.uint8))
    opt = step._opt
    opt.num_update = int(meta.get("opt_num_update", meta["step"]))
    opt._index_update_count.clear()
    for k, v in meta.get("opt_counts", ()):
        opt._index_update_count[int(k) if str(k).isdigit() else k] = int(v)
    return meta


def _to_host(tree):
    """The tree with every tensor copied to host memory (on the card into
    pinned buffers, on the copy stream, then synchronised)."""
    def walk(node, copy):
        if isinstance(node, dict):
            return {k: walk(v, copy) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, copy) for v in node]
        if isinstance(node, torch.Tensor):
            return copy(node)
        return node

    devs = []

    def find(t):
        if t.device.type == "cuda":
            devs.append(t.device)
        return t
    walk(tree, find)
    if not devs:
        return tree
    side = _copy_stream(devs[0])
    with torch.cuda.stream(side):
        def d2h(t):
            if t.device.type != "cuda":
                return t
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host
        out = walk(tree, d2h)
    side.synchronize()
    return out


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


class AsyncCheckpointer:
    """Every-K-steps asynchronous checkpointing for a training step; see
    the module docstring.  ``save(step)`` blocks only on a still-in-flight
    PREVIOUS write; ``latest()`` only ever surfaces manifest-verified
    snapshots.  ``waits`` holds the train thread's wait at the last saves,
    and ``writes`` the last durable writes' ``{"step", "seconds",
    "drain_seconds", "bytes"}`` (64 of each)."""

    def __init__(self, directory: Optional[str] = None,
                 every: Optional[int] = None):
        if directory is None:
            directory = str(env.MXNET_TPU_ELASTIC_DIR)
        if not directory:
            raise MXNetError(
                "elastic checkpointing needs a directory: pass one or set "
                "MXNET_TPU_ELASTIC_DIR")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every = int(env.MXNET_TPU_ELASTIC_CKPT_STEPS
                         if every is None else every)
        self._last_saved_step: Optional[int] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._inflight = threading.Event()
        self._inflight.set()  # set == idle
        self._error: Optional[BaseException] = None
        self._closed = False
        self.waits: deque = deque(maxlen=64)
        self.writes: deque = deque(maxlen=64)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mx-elastic-ckpt")
        self._worker.start()
        self.last_durable: Optional[Tuple[str, int]] = None

    # ------------------------------------------------------------- cadence
    def due(self, num_update: int) -> bool:
        """A full cadence window has elapsed since the last capture.
        Threshold, not modulo: a K-step caller lands on the first call
        boundary PAST the window, never on lcm(K, every)."""
        if self.every <= 0:
            return False
        last = self._last_saved_step
        return last is None or num_update - last >= self.every

    def save(self, step) -> None:
        """Capture now, write later."""
        if self._closed:
            raise MXNetError("AsyncCheckpointer is closed")
        t0 = time.perf_counter()
        self._inflight.wait()
        wait = time.perf_counter() - t0
        _M_CKPT_WAIT_SECONDS.observe(wait)
        self.waits.append(wait)
        # waiting on the previous write is checkpoint backpressure on the
        # train critical path (the write itself runs on the worker)
        from ..observability import goodput as _goodput
        _goodput.train().attribute("checkpoint", wait)
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError(
                f"async elastic checkpoint write failed: {err}") from err
        tree, ready = _capture_tree(step)
        meta = _capture_meta(step)
        self._last_saved_step = meta["step"]
        self._inflight.clear()
        _M_QUEUE.set(1)
        self._queue.put((tree, meta, ready))

    def wait(self) -> None:
        """Drain: block until every captured snapshot is durable."""
        self._inflight.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError(
                f"async elastic checkpoint write failed: {err}") from err

    def close(self) -> None:
        if self._closed:
            return
        self._inflight.wait()
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=30)

    def latest(self) -> Optional[Tuple[str, int]]:
        return latest_checkpoint(self.directory)

    # ------------------------------------------------------------- worker
    def _write(self, tree: dict, meta: dict, ready=None) -> None:
        """One durable checkpoint: wait for the device copies, drain them
        to the host, write the tree into a temp dir, then meta, manifest
        and ONE atomic rename."""
        from ..checkpoint import (_atomic_write_json, save_pytree,
                                  write_manifest)
        step_no = meta["step"]
        final = os.path.join(self.directory, _step_dirname(step_no))
        tmp = os.path.join(self.directory,
                           f".tmp-{_step_dirname(step_no)}-{os.getpid()}")
        t0 = time.perf_counter()
        with _tracing.span("elastic.checkpoint",
                           attrs={"step": step_no, "dir": self.directory}):
            if ready is not None:
                ready.synchronize()
            host = _to_host(tree)
            drain = time.perf_counter() - t0
            del tree
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            save_pytree(tmp, host, force=True, manifest=False)
            _atomic_write_json(os.path.join(tmp, "meta.json"), meta)
            write_manifest(tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        seconds = time.perf_counter() - t0
        _M_CKPT_SECONDS.observe(seconds)
        _M_CKPTS.inc()
        _M_LAST_STEP.set(step_no)
        _M_LAST_TIME.set(time.time())
        self.writes.append({"step": step_no, "seconds": seconds,
                            "drain_seconds": drain,
                            "bytes": _tree_bytes(host)})
        self.last_durable = (final, step_no)

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._write(*job)
            except BaseException as e:  # noqa: BLE001 - to the train thread
                self._error = e
            finally:
                del job
                _M_QUEUE.set(0)
                self._inflight.set()


# ---------------------------------------------------------------------------
# mesh reformation
# ---------------------------------------------------------------------------
class ElasticTrainStep:
    """Mesh reformation on rank loss: not ported.  It rebuilds a
    data-parallel device mesh on the surviving ranks;
    :class:`AsyncCheckpointer` and :func:`load_elastic_checkpoint` are its
    checkpoint half."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "ElasticTrainStep: mesh reformation on rank loss is not ported "
            "yet (ROADMAP A11b); AsyncCheckpointer and "
            "load_elastic_checkpoint are ported")
