"""Elastic training (counterpart of ``mxnet_tpu/resilience/elastic.py``):
async checkpoints off the critical path, mesh reformation on rank loss,
continue on the survivors.

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
  random streams and the optimizer's counts.  Global shapes are
  mesh-independent, so a step built for another mesh restores the same
  checkpoint (its sharded optimizer states re-slice).
* :class:`ElasticTrainStep` — drives a step so the job survives rank
  loss: a rank-loss-shaped failure (:func:`elastic_recoverable`) reforms
  the ``dp`` mesh on the survivors, rebuilds the step for it, restores
  the last durable checkpoint and replays the batches fed since, so the
  recovered trajectory is bit for bit a cold restart's from that
  checkpoint.  :class:`ElasticConfig` holds its knobs.

The port's mesh is single-controller: a mesh position is a device, and
several positions may share one card.  A rank's death is modeled at the
``allreduce`` and ``execute`` fault sites by a
:class:`~mxnet_tpu_torch.resilience.FaultPlan`, as the JAX package's
tier-1 gate models it; the reformed mesh takes the survivors' positions
from the old mesh's ``devices``.

Metrics: ``mxnet_tpu_elastic_*`` (checkpoints, write and wait seconds,
queue depth, last checkpoint step and time, reformations, lost steps,
world size); spans ``elastic.checkpoint`` and ``elastic.reform``; the
reformation is the train goodput ledger's ``reform`` bucket and two
flight-recorder events (``elastic.pre_reform``, ``elastic.reformed``).
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
from .faults import FaultInjected, maybe_fault
from .policy import RankFailureError, call_with_timeout

__all__ = ["AsyncCheckpointer", "ElasticConfig", "ElasticTrainStep",
           "elastic_recoverable", "latest_checkpoint",
           "load_elastic_checkpoint"]

_M_REFORMS = _metrics.registry().counter(
    "mxnet_tpu_elastic_reformations_total",
    "Mesh reformations completed after a rank loss: survivors agreed on a "
    "new world, re-sharded state from the last durable checkpoint, and "
    "training continued on N-1 ranks.")
_M_LOST = _metrics.registry().counter(
    "mxnet_tpu_elastic_lost_steps_total",
    "Training steps rolled back to the restored checkpoint by reformations "
    "(replayed from the driver's batch buffer when it still holds them; "
    "truly lost after a process crash).")

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
_M_WORLD = _metrics.registry().gauge(
    "mxnet_tpu_elastic_world_size",
    "Current data-parallel world size of the elastic training job "
    "(drops when a reformation continues on the survivors).")


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
        "world_dp": (step._mesh.axis_size("dp")
                     if step._mesh is not None else 1),
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
class ElasticConfig:
    """Knobs for :class:`ElasticTrainStep`; every default reads the env
    registry (``MXNET_TPU_ELASTIC_DIR``, ``MXNET_TPU_ELASTIC_CKPT_STEPS``,
    ``MXNET_TPU_ELASTIC_MAX_REFORMS``, ``MXNET_TPU_ELASTIC_MIN_DP``) so a
    launcher can arm elasticity without touching training code."""

    def __init__(self, directory: Optional[str] = None,
                 every: Optional[int] = None,
                 max_reforms: Optional[int] = None,
                 min_dp: Optional[int] = None):
        self.directory = (str(env.MXNET_TPU_ELASTIC_DIR)
                          if directory is None else directory)
        self.every = (int(env.MXNET_TPU_ELASTIC_CKPT_STEPS)
                      if every is None else int(every))
        self.max_reforms = (int(env.MXNET_TPU_ELASTIC_MAX_REFORMS)
                            if max_reforms is None else int(max_reforms))
        self.min_dp = max(1, int(env.MXNET_TPU_ELASTIC_MIN_DP)
                          if min_dp is None else int(min_dp))

    @classmethod
    def coerce(cls, value) -> "ElasticConfig":
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        return cls()  # True or anything truthy: the env defaults


def elastic_recoverable(exc: BaseException) -> bool:
    """Rank-loss classification: :class:`RankFailureError` (a collective
    timed out on a dead peer), any injected fault at the ``allreduce``
    site, a non-transient injected fault at ``execute`` (a rank dying
    inside the step), or a divergence-checksum mismatch naming a rank (its
    state is corrupt: evict it as if dead).  Not recoverable by
    reformation: transient backend errors (the inner retry ladder owns
    those), :class:`BackendUnavailableError` (the whole backend is gone,
    not one rank), and programming errors."""
    if isinstance(exc, RankFailureError):
        return True
    if isinstance(exc, FaultInjected):
        return exc.site == "allreduce" or \
            (exc.site == "execute" and not exc.transient)
    from ..observability.health import NumericsError
    return isinstance(exc, NumericsError) and \
        exc.diverging_rank is not None


class ElasticTrainStep:
    """Drive a training step so the job survives rank loss.

    ``build_step(mesh)`` makes the step (a ``CompiledTrainStep`` or a
    ``MultiStepTrainStep``); it is called once up front and once per
    reformation (a smaller world is another step, with its own graphs).
    ``mesh`` is the initial mesh (default: every visible device on
    ``dp``); ``config`` an :class:`ElasticConfig`; ``checkpointer`` an
    :class:`AsyncCheckpointer` to use instead of the config's.

    Call it as the step it wraps (``loss = estep(x, y)``); attribute
    access falls through to the live step.  The batches fed since the
    last durable checkpoint are buffered (bounded by the cadence), so a
    reformation replays them on the new mesh.  ``on_reform`` callbacks
    (``fn(new_mesh)``) let the surrounding pipeline follow
    (``DevicePrefetchIter.reshard``).
    """

    def __init__(self, build_step, mesh=None,
                 config: Optional[ElasticConfig] = None, checkpointer=None):
        from ..parallel.mesh import make_mesh
        self._build = build_step
        self._cfg = config or ElasticConfig()
        self._mesh = mesh if mesh is not None else make_mesh()
        self._step = build_step(self._mesh)
        self._world = max(self._mesh.axis_size("dp"), 1)
        self._ckpt = checkpointer or AsyncCheckpointer(
            self._cfg.directory, every=self._cfg.every)
        self._buffer: List[Tuple] = []
        self._executed = 0
        self._anchored = False
        self.reformations = 0
        self.on_reform: List = []
        _M_WORLD.set(self._world)

    # ------------------------------------------------------------- accessors
    @property
    def step(self):
        """The live inner step (rebuilt by each reformation)."""
        return self._step

    @property
    def mesh(self):
        return self._mesh

    @property
    def world_size(self) -> int:
        return self._world

    @property
    def checkpointer(self) -> AsyncCheckpointer:
        return self._ckpt

    def __getattr__(self, name):
        if name.startswith("__") or "_step" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self._step, name)

    # ------------------------------------------------------------- stepping
    def _probe_collective(self) -> None:
        """The per-step rank-liveness seam: the ``allreduce`` fault site
        under ``MXNET_KVSTORE_TIMEOUT``, which turns a hang into
        :class:`RankFailureError`, the protection the dist kvstore's
        collective guard gives (the step's own gradient reduction is
        inside its graph)."""
        timeout = float(env.MXNET_KVSTORE_TIMEOUT)
        desc = (f"elastic step collective (step {self._step._num_update}, "
                f"world dp={self._world})")

        def rank_failure(m):
            from . import _flight_notify
            exc = RankFailureError(
                m + "; a peer rank is dead or wedged — reforming the mesh "
                    "on the survivors")
            _flight_notify(exc, "allreduce", context={
                "collective": desc, "world_size": self._world,
                "num_update": int(self._step._num_update)})
            return exc

        call_with_timeout(lambda: maybe_fault("allreduce"), timeout, desc,
                          error=rank_failure)

    def __call__(self, x, y):
        if not self._anchored:
            # the step-0 anchor: recovery needs a durable snapshot even
            # before the first cadence point
            self._ckpt.save(self._step)
            self._anchored = True
        self._buffer.append((x, y))
        while True:
            try:
                loss = None
                while self._executed < len(self._buffer):
                    bx, by = self._buffer[self._executed]
                    self._probe_collective()
                    loss = self._step(bx, by)
                    self._executed += 1
                    if self._ckpt.due(self._step._num_update):
                        self._ckpt.save(self._step)
                        del self._buffer[:self._executed]
                        self._executed = 0
                    elif self._ckpt.every <= 0:
                        # no cadence: a reformation restores the step-0
                        # anchor and the rolled-back steps are lost (and
                        # metered); holding their batches would pin the
                        # whole run's inputs
                        del self._buffer[:self._executed]
                        self._executed = 0
                return loss
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if not elastic_recoverable(e):
                    raise
                self._reform(e)

    def finish(self) -> None:
        """Drain the async writer (end of training, before evaluation)."""
        self._ckpt.wait()

    def close(self) -> None:
        self._ckpt.close()

    # ------------------------------------------------------------- reformation
    def _agree_world(self, survivors: int) -> int:
        """Agreement on the world after a failure.  Across processes each
        survivor adds 1 to a bounded all-reduce (the seam the dist stores
        collect on) and the smaller view wins; in one process, where the
        dead rank is modeled by a FaultPlan, it is the local decision."""
        from .. import distributed
        if distributed.process_count() > 1:
            from ..parallel.collectives import cross_process_allreduce
            alive = call_with_timeout(
                lambda: cross_process_allreduce(torch.ones(1)),
                float(env.MXNET_KVSTORE_TIMEOUT) or 30.0,
                "elastic world agreement")
            return min(survivors, int(alive[0]))
        return survivors

    def _reform(self, exc: BaseException) -> None:
        from ..observability import flight_recorder as _fr
        from ..observability import goodput as _goodput
        from ..parallel.mesh import make_mesh
        if self.reformations >= self._cfg.max_reforms:
            raise MXNetError(
                f"elastic reformation budget exhausted "
                f"({self._cfg.max_reforms}); last rank failure: {exc}"
            ) from exc
        prev_step = int(self._step._num_update)
        # the world we came from goes to the flight ring first: if the
        # recovery itself dies, the post-mortem still shows it
        _fr.record_event("elastic.pre_reform",
                         world_size=self._world, num_update=prev_step,
                         reformations=self.reformations,
                         failure=f"{type(exc).__name__}: {exc}")
        with _tracing.span("elastic.reform",
                           attrs={"from_world": self._world,
                                  "failure": type(exc).__name__}), \
                _goodput.train().timed("reform"):
            self._ckpt.wait()  # an in-flight capture becomes durable first
            found = self._ckpt.latest()
            if found is None:
                raise MXNetError(
                    "mesh reformation needs a durable elastic checkpoint "
                    f"and none exists under {self._ckpt.directory}"
                ) from exc
            path, ckpt_step = found
            survivors = self._agree_world(self._world - 1)
            new_dp = 1 << max(survivors.bit_length() - 1, 0)
            if survivors < 1 or new_dp < self._cfg.min_dp:
                raise MXNetError(
                    f"cannot reform below min_dp={self._cfg.min_dp} "
                    f"(survivors={survivors}); last rank failure: {exc}"
                ) from exc
            # the survivors' positions: the old mesh's first new_dp
            # devices (several positions may share one card)
            new_mesh = make_mesh({"dp": new_dp},
                                 devices=self._mesh.devices[:new_dp])
            self._step = self._build(new_mesh)
            load_elastic_checkpoint(path, self._step)
            self._mesh, self._world = new_mesh, new_dp
            self._executed = 0  # replay every buffered batch on the new mesh
            self.reformations += 1
            _M_REFORMS.inc()
            _M_LOST.inc(max(prev_step - ckpt_step, 0))
            _M_WORLD.set(new_dp)
            for cb in self.on_reform:
                cb(new_mesh)
        _fr.record_event("elastic.reformed",
                         world_size=new_dp, restored_step=ckpt_step,
                         replaying=len(self._buffer))
