"""``mx.amp``: the top-level name of :mod:`mxnet_tpu_torch.contrib.amp`
(the reference exposes AMP under ``mx.contrib.amp``; newer MXNet moved it
to ``mx.amp``), as ``mxnet_tpu/amp.py`` is."""
from .contrib.amp import (LossScaler, convert_block, convert_hybrid_block,
                          init, lists, scale_loss, unscale)

__all__ = ["LossScaler", "convert_block", "convert_hybrid_block", "init",
           "lists", "scale_loss", "unscale"]
