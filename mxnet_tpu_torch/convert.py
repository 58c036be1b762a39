"""Weights from the JAX package into the port.

:func:`llama_state_dict_from_mxnet` takes the JAX model's parameters as
numpy arrays keyed by their ``collect_params()`` names (for example
``llamamodel0_layer0_attn_wq_weight`` or ``llamamodel0_rope_cos``) and loads
them into a :class:`~mxnet_tpu_torch.gluon.model_zoo.language.LlamaModel`.
The port's module names follow the JAX ones, so ``layers.0.attn.wq.weight``
is ``layer0_attn_wq_weight`` after the model's name prefix, and a MoE
block's ``layers.0.ffn.expert_w1`` is ``layer0_moe_expert_w1``.

:func:`resnet_state_dict_from_mxnet` maps by order instead: the JAX
ResNet's names count layers per stage and type
(``resnetv10_stage1_fusedconv1x1bn0_running_var``), and the port's
modules register their tensors in the JAX package's order, so the two
lists pair up one to one.

:func:`params_from_mxnet` carries weights into a Gluon block of the port
by name: the JAX model's ``collect_params()`` as numpy, key by key, into
the port block's ``collect_params()`` (both built under the same
``prefix=``).
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["llama_state_dict_from_mxnet", "resnet_state_dict_from_mxnet",
           "bert_state_dict_from_mxnet", "params_from_mxnet"]


def _mxnet_suffix(key: str) -> str:
    """``layers.3.ffn.w1.weight`` -> ``layer3_ffn_w1_weight``; a MoE
    block's ``layers.3.ffn.expert_w1`` -> ``layer3_moe_expert_w1`` (the JAX
    block names its MoE FFN ``moe_``)."""
    key = re.sub(r"\.ffn\.(router_weight|expert_w\d)$", r".moe.\1", key)
    return re.sub(r"^layers\.(\d+)\.", r"layer\1_", key).replace(".", "_")


def _load_named(params: Dict[str, np.ndarray], model, name_of
                ) -> Dict[str, torch.Tensor]:
    """Load ``params[name_of(key)]`` into each entry of ``model``'s state
    dict (cast to its dtype and device) and return the state.  Raises when
    a name is missing, left over, or has another shape."""
    own = model.state_dict()
    state, used = {}, set()
    for key, ref in own.items():
        name = name_of(key)
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


def _prefix_of(params, suffix: str) -> str:
    """The name prefix of the one parameter whose name ends in ``suffix``."""
    hits = [k for k in params if k.endswith(suffix)]
    if len(hits) != 1:
        raise MXNetError(f"expected one *{suffix}, found {hits}")
    return hits[0][: -len(suffix)]


def llama_state_dict_from_mxnet(params: Dict[str, np.ndarray], model
                                ) -> Dict[str, torch.Tensor]:
    """Map ``params`` onto ``model``'s state dict, load it (cast to each
    entry's dtype and device) and return it.  Raises when a name is
    missing, left over, or has another shape."""
    prefix = _prefix_of(params, "tok_embed_weight")
    return _load_named(params, model, lambda key: prefix + _mxnet_suffix(key))


# The port's BERT module names where the JAX package's prefixes differ.
_BERT_RENAMES = (("token_type_embed.", "type_embed."), ("attention.", "attn."),
                 ("proj.", "out."), ("mlm_transform.", "mlm_trans."))


def _bert_name(key: str, top: str, backbone: str) -> str:
    """``bert.encoder.layer0.attention.proj.weight`` ->
    ``<backbone>enc_layer0_attn_out_weight``; keys outside ``bert.`` take
    the ``top`` prefix (``mlm_bias`` -> ``<top>mlm_bias``)."""
    prefix = top
    if key.startswith("bert."):
        prefix, key = backbone, key[len("bert."):]
    key = re.sub(r"^encoder\.layer(\d+)\.", r"enc_layer\1.", key)
    for port, jax_name in _BERT_RENAMES:
        key = key.replace(port, jax_name)
    return prefix + key.replace(".", "_")


def bert_state_dict_from_mxnet(params: Dict[str, np.ndarray], model
                               ) -> Dict[str, torch.Tensor]:
    """Map ``params`` (the JAX ``BERTForPretraining``'s ``collect_params()``
    as numpy) onto ``model``'s state dict by name, load it (cast to each
    entry's dtype and device) and return it.  The MLM decoder's tied weight
    is the embedding's one entry on both sides.  Raises when a name is
    missing, left over, or has another shape."""
    top = _prefix_of(params, "mlm_bias")
    backbone = _prefix_of(params, "word_embed_weight")
    return _load_named(params, model,
                       lambda key: _bert_name(key, top, backbone))


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


def params_from_mxnet(ref_params: Dict[str, np.ndarray], net) -> None:
    """Write ``ref_params`` (the JAX block's ``collect_params()`` as numpy,
    by name) into ``net.collect_params()`` in place, each cast to its
    parameter's dtype; a deferred parameter takes the array's shape (call
    ``net.initialize`` first).  Raises on a name missing or left over on
    either side and on a shape that differs."""
    params = net.collect_params()
    missing = sorted(set(params.keys()) - set(ref_params))
    extra = sorted(set(ref_params) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"parameters do not pair up: missing {missing}, "
                         f"with no place {extra}")
    for name, p in params.items():
        arr = np.asarray(ref_params[name])
        known = p.shape or ()
        if len(known) != arr.ndim or any(
                s not in (0, a) for s, a in zip(known, arr.shape)):
            raise MXNetError(f"{name}: shape {arr.shape} != {p.shape}")
        p.set_data(arr)
