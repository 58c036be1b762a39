"""bf16 model conversion (counterpart of
``mxnet_tpu/contrib/amp/amp.py:convert_block``).

Op-level autocast and dynamic loss scaling wait for later slices."""
from __future__ import annotations

import torch

__all__ = ["convert_block"]

# Norm-layer parameters and running statistics stay fp32 under conversion.
_FP32_PARAM_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                        "moving_mean", "moving_var")


def convert_block(net, target_dtype: str = "bfloat16"):
    """Cast every fp32 parameter and buffer of ``net`` to ``target_dtype``
    in place, except those whose name (``state_dict`` key) ends in a norm
    suffix; returns ``net``."""
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError(f"target_dtype must be bfloat16 or float16, got "
                         f"{target_dtype!r}")
    dtype = getattr(torch, target_dtype)
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        if t.dtype == torch.float32 and not name.endswith(
                _FP32_PARAM_SUFFIXES):
            t.data = t.data.to(dtype)
    return net
