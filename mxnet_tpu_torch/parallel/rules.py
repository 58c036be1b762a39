"""Sharding rules: a :class:`~.mesh.PartitionSpec` for each parameter by
name and shape (counterpart of ``mxnet_tpu/parallel/rules.py``, whose
rule tables this module copies).

Megatron-style for transformers: column-parallel matrices (q/k/v, the
FFN's input) shard their output dim over ``tp``, row-parallel ones (the
output projections) their input dim; embeddings shard the vocabulary over
``tp``; stacked expert weights shard the expert dim over ``ep``; anything
else its largest dim over ``fsdp``; an axis that does not divide its dim
is dropped (replicated instead).

The rules match the JAX package's Gluon names (``layer0_attn_wq_weight``,
``moe_expert_w1``).  A port parameter's dotted name
(``layers.0.attn.wq.weight``) is matched in that form
(:func:`gluon_name`), so each parameter gets the spec the JAX package
gives its counterpart.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .mesh import PartitionSpec as P

__all__ = ["Rule", "DEFAULT_RULES", "LLAMA_RULES", "spec_for",
           "auto_param_spec_fn", "describe_sharding", "gluon_name"]


class Rule:
    """One rule: a name pattern (regex, searched) and an ndim -> spec."""

    def __init__(self, pattern: str, spec: Tuple, ndim: Optional[int] = None,
                 note: str = ""):
        self.pattern = re.compile(pattern)
        self.spec = tuple(spec)
        self.ndim = ndim
        self.note = note

    def matches(self, name: str, shape: Tuple[int, ...]) -> bool:
        if self.ndim is not None and len(shape) != self.ndim:
            return False
        return bool(self.pattern.search(name))

    def __repr__(self):
        return f"Rule({self.pattern.pattern!r} -> {self.spec})"


# Dense weights are [units_out, units_in] in both packages; conv kernels OIHW.
DEFAULT_RULES: List[Rule] = [
    Rule(r"expert_w\d", ("ep", None, None), ndim=3,
         note="expert-parallel: expert dim over ep"),
    Rule(r"router_weight", (None, None), ndim=2,
         note="MoE router stays replicated (tiny, read by every token)"),
    Rule(r"(qkv|query|key|value|ffn1|fc1|gate|up_proj)_?weight", ("tp", "fsdp"),
         ndim=2, note="column-parallel: out dim over tp"),
    Rule(r"(out|proj|ffn2|fc2|down_proj)_?weight", ("fsdp", "tp"),
         ndim=2, note="row-parallel: in dim over tp (psum after matmul)"),
    Rule(r"(word_)?embed\w*_weight", ("tp", "fsdp"),
         ndim=2, note="vocab-parallel embedding"),
    Rule(r"position_weight", (None, "fsdp"), ndim=2),
    Rule(r"(qkv|query|key|value|ffn1|fc1|gate|up_proj)_?bias", ("tp",), ndim=1),
    Rule(r"(conv|downsample)\w*_weight", ("fsdp", None, None, None), ndim=4),
    Rule(r"weight", ("fsdp", None), ndim=2),
    Rule(r"weight", ("fsdp", None, None, None), ndim=4),
]

LLAMA_RULES: List[Rule] = [
    Rule(r"(wq|wk|wv|w1|w3)_?weight", ("tp", "fsdp"), ndim=2),
    Rule(r"(wo|w2)_?weight", ("fsdp", "tp"), ndim=2),
    Rule(r"tok_embed\w*_weight", ("tp", "fsdp"), ndim=2),
] + DEFAULT_RULES


def gluon_name(name: str) -> str:
    """A port parameter's dotted name in the JAX package's Gluon form:
    ``layers.3.ffn.w1.weight`` -> ``layer3_ffn_w1_weight``."""
    return re.sub(r"(^|\.)layers\.(\d+)\.", r"\1layer\2_", name).replace(
        ".", "_")


def _divisible(spec: Sequence, shape: Tuple[int, ...], axes: Dict[str, int]):
    """Drop mesh axes that don't divide their dim (replicate instead)."""
    clean = []
    for i, entry in enumerate(spec[:len(shape)]):
        if entry is None:
            clean.append(None)
            continue
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        total = 1
        kept = []
        for a in names:
            size = axes.get(a, 1)
            if size > 1 and shape[i] % (total * size) == 0:
                kept.append(a)
                total *= size
        clean.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    while clean and clean[-1] is None:
        clean.pop()
    return P(*clean)


def spec_for(name: str, shape: Tuple[int, ...], axes: Dict[str, int],
             rules: Optional[List[Rule]] = None) -> P:
    """The spec of one parameter: the first matching rule, with
    non-dividing axes dropped; an unmatched parameter of 2 or more dims
    takes fsdp over its largest dividing dim, else it is replicated."""
    for rule in (rules if rules is not None else DEFAULT_RULES):
        if rule.matches(name, tuple(shape)):
            return _divisible(rule.spec, tuple(shape), axes)
    fsdp = axes.get("fsdp", 1)
    if fsdp > 1 and len(shape) >= 2:
        cands = [(d, -i) for i, d in enumerate(shape) if d % fsdp == 0]
        if cands:
            _, neg_i = max(cands)
            spec = [None] * len(shape)
            spec[-neg_i] = "fsdp"
            return _divisible(spec, tuple(shape), axes)
    return P()


def auto_param_spec_fn(mesh, rules: Optional[List[Rule]] = None) -> Callable:
    """``param_spec_fn`` for
    :class:`~mxnet_tpu_torch.executor.CompiledTrainStep`: ``fn(name,
    tensor)`` (a module's parameter by its dotted name) or ``fn(param)``
    (a Gluon ``Parameter``) looks the parameter up in the rule table
    against this mesh's axes."""
    axes = mesh.axes

    def fn(param, tensor=None) -> P:
        if tensor is None:
            name = getattr(param, "name", str(param))
            shape = tuple(getattr(param, "shape", None) or ())
        else:
            name, shape = gluon_name(param), tuple(tensor.shape)
        return spec_for(name, shape, axes, rules)

    return fn


def describe_sharding(net, mesh, rules: Optional[List[Rule]] = None) -> str:
    """A table of how ``net``'s parameters land on ``mesh``."""
    fn = auto_param_spec_fn(mesh, rules)
    lines = []
    for name, p in net.named_parameters():
        lines.append(f"{name:60s} {str(tuple(p.shape)):20s} {fn(name, p)}")
    return "\n".join(lines)
