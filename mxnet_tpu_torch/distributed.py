"""Multi-process jobs on ``torch.distributed`` (counterpart of
``mxnet_tpu/distributed.py``).

The reference MXNet wired a ps-lite scheduler, servers and workers from
``DMLC_*`` variables; the JAX package runs every process as one SPMD
program over ``jax.distributed``.  Here every process is one rank of a
``torch.distributed`` process group, and the dist kvstores reduce across
ranks with its collectives: NCCL between cards, gloo on the CPU (gloo
also takes CUDA tensors for ``all_reduce`` and ``broadcast``, staged
through the host).

Environment contract (either naming scheme works; ``tools/launch.py``
sets both):

====================  =========================  =========================
meaning               native name                reference (DMLC) name
====================  =========================  =========================
coordinator address   MXNET_DIST_COORDINATOR     DMLC_PS_ROOT_URI ":" PORT
process count         MXNET_DIST_NUM_PROCESSES   DMLC_NUM_WORKER
process id            MXNET_DIST_PROCESS_ID      DMLC_WORKER_ID
====================  =========================  =========================

``initialize()`` with no arguments reads these, and with no coordinator
anywhere it is a one-process no-op.  The coordinator's address is the
process group's rendezvous (``tcp://host:port``).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .base import MXNetError, env

__all__ = ["initialize", "finalize", "is_initialized", "process_count",
           "process_index", "local_rank", "barrier"]

_owns_group = False
_LOOPBACK = ("127.", "localhost", "::1")


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def _ranks_on_this_host(num_processes: int, coordinator: str) -> int:
    """Ranks of the job that share this host: torchrun's
    ``LOCAL_WORLD_SIZE`` when set, every rank when the coordinator is a
    loopback address (the local launcher), else one."""
    v = _env("LOCAL_WORLD_SIZE")
    if v:
        return int(v)
    return num_processes if coordinator.startswith(_LOOPBACK) else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the job as one rank of a ``torch.distributed`` process group
    (idempotent; a group made by the caller is adopted, not owned).

    ``backend`` None picks NCCL when this process can see a card and gloo
    otherwise.  NCCL refuses two ranks on one card, so an NCCL job with
    more ranks on this host than cards raises :class:`MXNetError` (pass
    ``backend="gloo"``); nothing changes the backend by itself.
    ``MXNET_KVSTORE_TIMEOUT`` > 0 becomes the group's timeout."""
    global _owns_group
    if _live():
        return
    coordinator_address = coordinator_address or _env("MXNET_DIST_COORDINATOR")
    if coordinator_address is None:
        uri, port = _env("DMLC_PS_ROOT_URI"), _env("DMLC_PS_ROOT_PORT")
        if uri and port:
            coordinator_address = f"{uri}:{port}"
    if num_processes is None:
        v = _env("MXNET_DIST_NUM_PROCESSES", "DMLC_NUM_WORKER")
        num_processes = int(v) if v else None
    if process_id is None:
        v = _env("MXNET_DIST_PROCESS_ID", "DMLC_WORKER_ID")
        process_id = int(v) if v else None
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise MXNetError(
                "distributed.initialize: num_processes > 1 but no "
                "coordinator address (set MXNET_DIST_COORDINATOR or use "
                "tools/launch.py)")
        return
    if num_processes is None or process_id is None:
        raise MXNetError("distributed.initialize: a coordinator needs the "
                         "process count and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        here = _ranks_on_this_host(num_processes, coordinator_address)
        cards = torch.cuda.device_count()
        if here > cards:
            raise MXNetError(
                f"distributed.initialize: {here} ranks on this host but "
                f"{cards} CUDA card(s); NCCL refuses two ranks on one card. "
                "Pass backend='gloo' to run them over gloo")
    kwargs = {}
    timeout = float(env.MXNET_KVSTORE_TIMEOUT)
    if timeout > 0:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    _owns_group = True


def is_initialized() -> bool:
    return _live()


def finalize() -> None:
    """Destroy the process group, if :func:`initialize` made it."""
    global _owns_group
    if _owns_group and _live():
        dist.destroy_process_group()
    _owns_group = False


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def local_rank() -> int:
    """Rank within this host (``MXNET_DIST_LOCAL_RANK``, else torchrun's
    ``LOCAL_RANK``, else 0)."""
    return int(_env("MXNET_DIST_LOCAL_RANK", "LOCAL_RANK", default="0"))


def barrier() -> None:
    """Block until every rank arrives (reference ``KVStore::Barrier``);
    a no-op in one process."""
    if process_count() > 1:
        dist.barrier()
