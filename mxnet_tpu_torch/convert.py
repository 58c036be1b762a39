"""Weights from the JAX package into the port.

:func:`llama_state_dict_from_mxnet` takes the JAX model's parameters as
numpy arrays keyed by their ``collect_params()`` names (for example
``llamamodel0_layer0_attn_wq_weight`` or ``llamamodel0_rope_cos``) and loads
them into a :class:`~mxnet_tpu_torch.gluon.model_zoo.language.LlamaModel`.
The port's module names follow the JAX ones, so ``layers.0.attn.wq.weight``
is ``layer0_attn_wq_weight`` after the model's name prefix.

:func:`resnet_state_dict_from_mxnet` maps by order instead: the JAX
ResNet's names count layers per stage and type
(``resnetv10_stage1_fusedconv1x1bn0_running_var``), and the port's
modules register their tensors in the JAX package's order, so the two
lists pair up one to one.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["llama_state_dict_from_mxnet", "resnet_state_dict_from_mxnet"]


def _mxnet_suffix(key: str) -> str:
    """``layers.3.ffn.w1.weight`` -> ``layer3_ffn_w1_weight``."""
    return re.sub(r"^layers\.(\d+)\.", r"layer\1_", key).replace(".", "_")


def llama_state_dict_from_mxnet(params: Dict[str, np.ndarray], model
                                ) -> Dict[str, torch.Tensor]:
    """Map ``params`` onto ``model``'s state dict, load it (cast to each
    entry's dtype and device) and return it.  Raises when a name is
    missing, left over, or has another shape."""
    heads = [k for k in params if k.endswith("tok_embed_weight")]
    if len(heads) != 1:
        raise MXNetError(f"expected one *tok_embed_weight, found {heads}")
    prefix = heads[0][: -len("tok_embed_weight")]
    own = model.state_dict()
    state, used = {}, set()
    for key, ref in own.items():
        name = prefix + _mxnet_suffix(key)
        if name not in params:
            raise MXNetError(f"no parameter {name!r} for {key!r}")
        arr = np.asarray(params[name])
        if tuple(arr.shape) != tuple(ref.shape):
            raise MXNetError(f"{name}: shape {arr.shape} != {tuple(ref.shape)}")
        state[key] = torch.tensor(arr, dtype=ref.dtype, device=ref.device)
        used.add(name)
    extra = sorted(set(params) - used)
    if extra:
        raise MXNetError(f"parameters with no place in the model: {extra}")
    model.load_state_dict(state)
    return state


_ROLES = ("weight", "bias", "gamma", "beta", "running_mean", "running_var")


def _role(name: str, sep: str) -> str:
    for role in _ROLES:
        if name.endswith(sep + role):
            return role
    return "?"


def resnet_state_dict_from_mxnet(params: Dict[str, np.ndarray], model
                                 ) -> Dict[str, torch.Tensor]:
    """Map ``params`` (the JAX ResNet's ``collect_params()`` as numpy, in
    its order) onto ``model``'s state dict in order, load it (cast to each
    entry's dtype and device) and return it.  Each pair must agree in shape
    and role (weight, bias, gamma, beta, running_mean, running_var); raises
    on a mismatch and on a tensor missing or left over on either side."""
    own = model.state_dict()
    names = list(params)
    state = {}
    for i, (key, ref) in enumerate(own.items()):
        if i >= len(names):
            raise MXNetError(f"no parameter for {key!r} (and "
                             f"{len(own) - i - 1} more): the JAX model has "
                             f"only {len(names)}")
        name = names[i]
        arr = np.asarray(params[name])
        if _role(name, "_") != _role(key, "."):
            raise MXNetError(f"{name} does not pair with {key}: roles "
                             f"{_role(name, '_')} and {_role(key, '.')}")
        if tuple(arr.shape) != tuple(ref.shape):
            raise MXNetError(f"{name}: shape {arr.shape} != "
                             f"{tuple(ref.shape)} of {key}")
        state[key] = torch.tensor(arr, dtype=ref.dtype, device=ref.device)
    extra = names[len(own):]
    if extra:
        raise MXNetError(f"parameters with no place in the model: {extra}")
    model.load_state_dict(state)
    return state
