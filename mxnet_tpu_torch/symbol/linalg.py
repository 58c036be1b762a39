"""``mx.sym.linalg`` (counterpart of ``mxnet_tpu/symbol/linalg.py``):
symbolic composers over the same ``_linalg_*`` ops as ``mx.nd.linalg``."""
from __future__ import annotations

from ..ndarray.linalg import _OPS
from .symbol import invoke_symbol

__all__ = list(_OPS) + ["svd"]


def _make(name, opname):
    def fn(*args, name=None, **kwargs):
        return invoke_symbol(opname, list(args), kwargs, name=name)
    fn.__name__ = name
    fn.__doc__ = f"Symbolic ``{opname}``."
    return fn


for _name in _OPS:
    globals()[_name] = _make(_name, "_linalg_" + _name)
svd = _make("svd", "svd")
del _name
