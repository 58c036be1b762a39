"""``mxnet_tpu_torch.fleet``: the fleet serving tier, replicated engines
behind a prefix-aware router.

Counterpart of ``mxnet_tpu/fleet``.  A single
:class:`~mxnet_tpu_torch.serving.server.ModelServer` serves one card; the
fleet tier spreads requests over N of them without changing the client
contract:

* :mod:`manager`: :class:`ReplicaManager` spawns one engine process per
  role (``mixed`` / ``prefill`` / ``decode``), waits for ``/ping``,
  SIGTERM-drains on stop, and its supervisor respawns dead replicas on
  their ports;
* :mod:`router`: :class:`Router`, the front door.  It polls each
  replica's ``GET /fleet/state`` (health, load, prefix-page digest),
  routes ``/generate`` to the replica with the longest advertised prefix
  match (else the least loaded), re-routes around dead or shedding
  replicas, relays SSE streams with a resume journal (live migration,
  hedged first tokens, rolling restarts), and, when the fleet has both
  prefill and decode replicas, disaggregates: prompt K/V computed on a
  prefill replica crosses HTTP and is admitted into a decode replica's
  page pool under the same chain hashes.

Quick start (two mixed replicas already serving on :8001/:8002)::

    from mxnet_tpu_torch.fleet import Router
    router = Router(["http://127.0.0.1:8001", "http://127.0.0.1:8002"])
    router.start_http("127.0.0.1", 8000)

``tools/serve_torch.py --replicas N`` (or ``--roles prefill:1,decode:2``)
runs the whole stack, spawn, warm and route, in one command.
"""
from .manager import ManagedReplica, ReplicaManager, free_port
from .router import ReplicaDeadError, ReplicaEndpoint, Router

__all__ = ["Router", "ReplicaEndpoint", "ReplicaDeadError",
           "ReplicaManager", "ManagedReplica", "free_port"]
