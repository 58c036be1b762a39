"""AMP, automatic mixed precision for the port (counterpart of
``mxnet_tpu/contrib/amp``; reference ``python/mxnet/contrib/amp``): model
conversion, op-level autocast by the op lists, and dynamic loss scaling
for ``gluon.Trainer``."""
from . import lists
from .amp import (LossScaler, convert_block, convert_bucketing_module,
                  convert_hybrid_block, convert_model, convert_symbol,
                  deinit, init, init_trainer, is_active,
                  list_conditional_fp32_ops, list_fp16_fp32_ops,
                  list_fp16_ops, list_fp32_ops, scale_loss, unscale)

__all__ = ["convert_block", "convert_hybrid_block", "deinit", "init",
           "is_active", "scale_loss", "unscale", "LossScaler", "lists",
           "convert_symbol", "convert_model", "convert_bucketing_module",
           "init_trainer", "list_fp16_ops", "list_fp32_ops",
           "list_fp16_fp32_ops", "list_conditional_fp32_ops"]
