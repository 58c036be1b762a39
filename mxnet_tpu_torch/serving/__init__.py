"""``mxnet_tpu_torch.serving``: dynamic batching over a bucket ladder for
any block, and continuous-batching generation over a paged KV cache (or
the dense no-cache engine), served in process and over HTTP.

* :mod:`engine` — :class:`InferenceEngine`: the bucket ladder over a
  :class:`~mxnet_tpu_torch.cached_op.CachedOp`, from a block or an
  export's files;
* :mod:`batcher` — :class:`DynamicBatcher`: ``max_batch`` /
  ``max_wait_us`` packing, host-staged, with admission control;
* :mod:`paged_cache` — :class:`PagePool`: device page pool with prefix
  sharing;
* :mod:`generation` — :class:`GenerationScheduler`: iteration-level
  continuous batching with speculative decoding and warmup, each engine
  through one CachedOp (CUDA graphs on the card), and
  :func:`greedy_decode`, its solo oracle;
* :mod:`server` — :class:`ModelServer` (``register`` /
  ``register_generation``, ``start_http``: predict, generate with SSE,
  cancel, ping, stats, metrics, goodput) and :class:`Client`, in process
  or over the socket;
* :mod:`stats`, :mod:`hostbuf` — per-model statistics and reusable host
  staging buffers.
"""
from .batcher import DynamicBatcher
from .engine import InferenceEngine, bucket_for, bucket_ladder
from .generation import (DEFAULT_EOS, GenerationScheduler, TokenStream,
                         greedy_decode, length_bucket)
from .paged_cache import PagePool, page_hash_chain, pages_needed
from .server import Client, ModelServer
from .stats import ServingStats

__all__ = ["Client", "DynamicBatcher", "GenerationScheduler",
           "InferenceEngine", "ModelServer", "ServingStats", "TokenStream",
           "bucket_for", "bucket_ladder", "greedy_decode", "length_bucket",
           "DEFAULT_EOS", "PagePool", "page_hash_chain", "pages_needed"]
