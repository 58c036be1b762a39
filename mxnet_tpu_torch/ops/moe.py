"""Mixture-of-Experts FFN (counterpart of ``mxnet_tpu/ops/moe.py``), the
GShard/Switch dense dispatch:

* gating: a softmax router, top-k experts per token (ties to the lower
  index, as ``lax.top_k``), their weights renormalized;
* capacity ``C = ceil(T / E * capacity_factor)``; each token's slot in an
  expert by a cumsum in the probabilities' dtype, slot by slot of the
  top-k; a token past an expert's capacity is dropped from it;
* dispatch and combine as one-hot ``(T, E, C)`` tensors contracted with
  the tokens;
* the Switch load-balance term, ``sum(mean gate * top-1 fraction) * E``.

Under a mesh whose ``ep`` axis shards the stacked expert weights (the
rule ``expert_w\\d -> ("ep", None, None)``, or the spec a training step
records for them), routing is computed once over every token, as the
unsharded op does; the tokens are split over the ``dp`` and ``ep``
positions, and each position holds ``E / ep`` experts.  Each position's
``(E, C, d)`` slots go to their experts' owners and the outputs come back
through :func:`~mxnet_tpu_torch.parallel.collectives.all_to_all`, once
each way, over ``ep`` (the exchange the JAX package's partitioner
inserts).  Each slot holds one token, so the exchange adds exact zeros
and the result is the unsharded op's up to the expert products'
rounding.  A token count that ``ep`` does not divide runs unsharded.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["moe_capacity"]


def moe_capacity(num_tokens: int, num_experts: int,
                 capacity_factor: float) -> int:
    return max(1, int(math.ceil(num_tokens / num_experts * capacity_factor)))


def _one_hot(idx, n: int, dtype):
    """One-hot rows of ``idx``; an index outside ``[0, n)`` gives a zero
    row, as ``jax.nn.one_hot`` (and no host sync, unlike ``F.one_hot``)."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)
            ).to(dtype)


def _dispatch_combine(probs, top_k: int, capacity: int):
    """(dispatch ``(T, E, C)`` one-hot, combine ``(T, E, C)`` weights, the
    load-balance scalar)."""
    _, e = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    counts = probs.new_zeros(e)
    dispatch = combine = None
    for s in range(top_k):
        oh = _one_hot(idx[:, s], e, probs.dtype)                   # (T, E)
        pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]       # (T, E)
        keep = oh * (pos < capacity).to(probs.dtype)
        slot = keep[:, :, None] * _one_hot(pos.to(torch.int32), capacity,
                                           probs.dtype)            # (T, E, C)
        dispatch = slot if dispatch is None else dispatch + slot
        weighted = vals[:, s][:, None, None] * slot
        combine = weighted if combine is None else combine + weighted
        counts = counts + oh.sum(dim=0)
    me = probs.mean(dim=0)
    ce = _one_hot(torch.argmax(probs, dim=-1), e, probs.dtype).mean(dim=0)
    return dispatch, combine, (me * ce).sum() * e


def _experts(expert_in, w1, w2):
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w1))
    return torch.einsum("ech,ehd->ecd", h, w2)


def _expert_mesh(w1, mesh):
    """The mesh and the axes of the token split when ``w1`` is sharded
    over ``ep``, else None."""
    from ..parallel.mesh import current_mesh, layout_of
    from ..parallel.rules import DEFAULT_RULES, spec_for
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh.axis_size("ep") < 2:
        return None
    spec = layout_of(w1)
    if spec is None:
        spec = spec_for("expert_w1", tuple(w1.shape), mesh.axes,
                        DEFAULT_RULES)
    first = spec[0] if len(spec) else None
    if first != "ep" and not (isinstance(first, tuple) and "ep" in first):
        return None
    return mesh


def _sharded_experts(dispatch, combine, t, w1, w2, mesh):
    """The expert FFN with the experts over ``ep`` and the tokens over
    ``dp`` x ``ep`` (or ``ep`` alone when they do not divide): ``y
    (T, d)``."""
    from ..parallel import collectives as C
    from ..parallel.mesh import PartitionSpec as P
    ep = mesh.axis_size("ep")
    n_tok = ep * mesh.axis_size("dp")
    tok = ("dp", "ep") if mesh.axis_size("dp") > 1 and \
        t.shape[0] % n_tok == 0 else "ep"
    e, cap, d = w1.shape[0], dispatch.shape[2], t.shape[1]
    e_loc = e // ep

    def body(disp, comb, toks, w1s, w2s):
        # each position's partial slots, with which of them it owns
        part = [torch.cat([torch.einsum("tec,td->ecd", a, x),
                           a.sum(dim=0)[:, :, None]], dim=-1)
                for a, x in zip(disp, toks)]
        got = C.all_to_all(part, "ep", split_axis=0, concat_axis=0)
        out = []
        for g, a, b in zip(got, w1s, w2s):
            g = g.reshape(ep, e_loc, cap, d + 1)
            res = _experts(g[..., :d].sum(dim=0), a, b)
            # to each source the slots it owns
            out.append(torch.cat([res * g[j, :, :, d:] for j in range(ep)]))
        back = C.all_to_all(out, "ep", split_axis=0, concat_axis=0)
        return [torch.einsum("tec,ecd->td", c, r) for c, r in zip(comb, back)]

    spec_t = P(tok, None, None)
    return C.shard_map(body, mesh, (spec_t, spec_t, P(tok, None), P("ep"),
                                    P("ep")), P(tok, None))(
        dispatch, combine, t, w1, w2)


@register("_moe_ffn", nin=4, nout=2)
def _moe_ffn(x, gate_weight, w1, w2, top_k=2, capacity_factor=1.25,
             num_experts=0, mesh=None):
    """``(y, aux_loss)`` = MoE-FFN(x).  x: ``(..., d)`` tokens;
    gate_weight: ``(d, E)``; w1: ``(E, d, h)``; w2: ``(E, h, d)``.  The
    leading dims flatten to the token axis and come back in y.  ``mesh``
    (default: the entered one) shards the experts as the module docstring
    says."""
    e = w1.shape[0]
    if num_experts and int(num_experts) != e:
        raise ValueError(f"num_experts={num_experts} does not match the "
                         f"stacked expert weights ({e} experts)")
    d = x.shape[-1]
    lead = tuple(x.shape[:-1])
    t = x.reshape(-1, d)
    cap = moe_capacity(t.shape[0], e, float(capacity_factor))
    probs = torch.softmax(torch.matmul(t, gate_weight).float(), dim=-1)
    dispatch, combine, aux = _dispatch_combine(probs, int(top_k), cap)
    dispatch, combine = dispatch.to(t.dtype), combine.to(t.dtype)
    sharded = _expert_mesh(w1, mesh)
    if sharded is not None and e % sharded.axis_size("ep"):
        raise MXNetError(f"_moe_ffn: {e} experts do not split over ep "
                         f"({sharded.axis_size('ep')})")
    if sharded is not None and t.shape[0] % sharded.axis_size("ep") == 0:
        y = _sharded_experts(dispatch, combine, t, w1, w2, sharded)
    else:
        expert_in = torch.einsum("tec,td->ecd", dispatch, t)
        y = torch.einsum("tec,ecd->td", combine, _experts(expert_in, w1, w2))
    return y.reshape(lead + (d,)), aux.to(t.dtype)
