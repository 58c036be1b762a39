"""Automatic naming (counterpart of ``mxnet_tpu/name.py``, reference
``python/mxnet/name.py``): ``NameManager`` hands out ``op0``-style names
and ``Prefix`` prepends a scope prefix, so ``with mx.name.Prefix('enc_'):``
namespaces what is named inside it."""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["NameManager", "Prefix", "current"]

_tls = threading.local()


class NameManager:
    def __init__(self):
        self._counter = {}

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()


class Prefix(NameManager):
    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        return self._prefix + super().get(name, hint)


def current() -> NameManager:
    """The innermost active manager (a thread's default one outside any
    ``with``)."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        if not hasattr(_tls, "default"):
            _tls.default = NameManager()
        return _tls.default
    return stack[-1]
