"""Reductions across replicas and processes (counterpart of
``mxnet_tpu/parallel/``; so far the part the kvstore uses)."""
from . import collectives
from .collectives import (allreduce_flat, broadcast_from, cross_process_allreduce,
                          pairwise_sum)

__all__ = ["collectives", "allreduce_flat", "broadcast_from",
           "cross_process_allreduce", "pairwise_sum"]
