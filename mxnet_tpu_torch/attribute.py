"""Attribute scoping for symbol construction (counterpart of
``mxnet_tpu/attribute.py``; reference ``python/mxnet/attribute.py:27``):
``with mx.AttrScope(group='stage1'):`` stamps every symbol made inside with
the given attributes (variables take them as their attrs, op nodes as
``__attr_<k>__``, out of the op's kwargs), so the symbol JSON carries
them as the JAX package's does."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]

_tls = threading.local()


class AttrScope:
    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = dict(kwargs)

    def get(self, attr: Optional[Dict] = None) -> Dict:
        """The scope's attributes with the explicitly passed ones over
        them."""
        if not self._attr:
            return dict(attr or {})
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        merged = AttrScope()
        merged._attr = {**(stack[-1]._attr if stack else {}), **self._attr}
        stack.append(merged)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()


def current() -> AttrScope:
    """The innermost active scope (an empty one outside any)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else AttrScope()
