"""Parallelism: device meshes, collectives, sharding rules, the pipeline
and sequence-parallel attention (counterpart of ``mxnet_tpu/parallel/``),
with the cross-process reductions the kvstore uses."""
from . import collectives
from .collectives import (allreduce, allreduce_arrays, allreduce_flat,
                          all_gather, all_to_all, barrier, broadcast_from,
                          cross_process_allreduce, pairwise_sum, pmax, pmean,
                          ppermute, psum, reduce_scatter, shard_map)
from .mesh import (AXIS_ORDER, DeviceMesh, NamedSharding, PartitionSpec,
                   current_mesh, default_mesh, make_mesh)
from .pipeline import PipelineStage, spmd_pipeline, stack_stage_params
from .ring_attention import (ring_attention, ring_attention_local,
                             ulysses_attention, ulysses_attention_local)
from .rules import (DEFAULT_RULES, LLAMA_RULES, Rule, auto_param_spec_fn,
                    describe_sharding, spec_for)

__all__ = [
    "AXIS_ORDER", "DeviceMesh", "make_mesh", "current_mesh", "default_mesh",
    "PartitionSpec", "NamedSharding",
    "psum", "pmean", "pmax", "all_gather", "reduce_scatter", "ppermute",
    "all_to_all", "allreduce", "allreduce_arrays", "barrier", "shard_map",
    "ring_attention", "ring_attention_local",
    "ulysses_attention", "ulysses_attention_local",
    "Rule", "DEFAULT_RULES", "LLAMA_RULES", "spec_for", "auto_param_spec_fn",
    "describe_sharding", "PipelineStage", "spmd_pipeline",
    "stack_stage_params",
    "collectives", "allreduce_flat", "broadcast_from",
    "cross_process_allreduce", "pairwise_sum"]
