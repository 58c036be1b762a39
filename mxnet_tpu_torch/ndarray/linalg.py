"""``mx.nd.linalg`` (counterpart of ``mxnet_tpu/ndarray/linalg.py``,
reference ``python/mxnet/ndarray/linalg.py``): the ``_linalg_*`` ops of
``ops/linalg.py`` under their short names."""
from __future__ import annotations

from .ndarray import invoke

_OPS = ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk", "gelqf",
        "syevd", "sumlogdiag", "extractdiag", "makediag", "extracttrian",
        "maketrian", "inverse", "det", "slogdet")

__all__ = list(_OPS) + ["svd"]


def _make(name, opname):
    def fn(*args, **kwargs):
        return invoke(opname, list(args), kwargs)
    fn.__name__ = name
    fn.__doc__ = f"``{opname}`` (see ``ops/linalg.py``)."
    return fn


for _name in _OPS:
    globals()[_name] = _make(_name, "_linalg_" + _name)
svd = _make("svd", "svd")
del _name
