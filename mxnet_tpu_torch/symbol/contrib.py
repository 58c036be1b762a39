"""``mx.sym.contrib`` (counterpart of ``mxnet_tpu/symbol/contrib.py``):
every ``_contrib_<x>`` op of the registry as the composer ``<x>``, also
one registered after import (the helpers are shared with
``mx.nd.contrib``)."""
from __future__ import annotations

import sys

from ..ops import registry as _registry


def _codegen_contrib_namespace():
    _registry.expose_contrib_namespace(sys.modules[__name__],
                                       sys.modules[__package__])


def __getattr__(name: str):
    """An op registered after import."""
    from . import _make_sym_func
    return _registry.resolve_contrib_late(sys.modules[__name__], name,
                                          _make_sym_func)
