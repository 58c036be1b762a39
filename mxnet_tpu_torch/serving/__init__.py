"""``mxnet_tpu_torch.serving``: continuous-batching generation over a paged
KV cache (or the dense no-cache engine), served in-process.

* :mod:`paged_cache` — :class:`PagePool`: device page pool with prefix
  sharing;
* :mod:`generation` — :class:`GenerationScheduler`: iteration-level
  continuous batching, and :func:`greedy_decode`, its solo oracle;
* :mod:`server` — :class:`ModelServer`: daemon step loops behind
  ``generate`` / ``generate_async`` / ``generate_stream``;
* :mod:`stats`, :mod:`hostbuf` — per-model statistics and reusable host
  staging buffers.
"""
from .generation import (DEFAULT_EOS, GenerationScheduler, TokenStream,
                         greedy_decode, length_bucket)
from .paged_cache import PagePool, page_hash_chain, pages_needed
from .server import ModelServer
from .stats import ServingStats

__all__ = ["GenerationScheduler", "ModelServer", "ServingStats", "TokenStream",
           "greedy_decode", "length_bucket", "DEFAULT_EOS", "PagePool",
           "page_hash_chain", "pages_needed"]
