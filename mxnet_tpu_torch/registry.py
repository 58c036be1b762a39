"""Generic class-registry factories (counterpart of
``mxnet_tpu/registry.py``; reference ``python/mxnet/registry.py``):
``get_register_func`` / ``get_alias_func`` / ``get_create_func`` build the
register/alias/create triple any base class (optimizers, initializers,
evaluation metrics...) hangs its string-keyed factory on.
"""
from __future__ import annotations

import json
import warnings

from .base import MXNetError

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func"]

_REGISTRIES = {}


def get_registry(base_class):
    """A copy of the name->class registry for ``base_class``
    (reference registry.py:32)."""
    return dict(_REGISTRIES.get(base_class, {}))


def get_register_func(base_class, nickname):
    """Build a ``register(klass, name=None)`` for ``base_class``
    (reference registry.py:49)."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            f"Can only register subclass of {base_class.__name__}"
        name = (name or klass.__name__).lower()
        if name in registry and registry[name] is not klass:
            warnings.warn(f"new {nickname} {klass.__name__} registered with "
                          f"name {name} is overriding existing "
                          f"{nickname} {registry[name].__name__}")
        registry[name] = klass
        return klass

    register.__doc__ = f"Register {nickname} to the {nickname} factory."
    return register


def get_alias_func(base_class, nickname):
    """Build an ``alias(*names)`` decorator factory (reference registry.py:88)."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    alias.__doc__ = f"Get registrator function that allows aliases for {nickname}."
    return alias


def get_create_func(base_class, nickname):
    """Build a ``create(spec, **kwargs)`` factory accepting a name, an
    instance, or a json config string (reference registry.py:115)."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def create(*args, **kwargs):
        if args:
            name, args = args[0], args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert not args and not kwargs, (
                f"{nickname} is already an instance. Additional arguments are "
                f"invalid")
            return name
        if isinstance(name, dict):
            return create(**name)
        assert isinstance(name, str), f"{nickname} must be of string type"
        if name.startswith("["):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        if name.startswith("{"):
            assert not args and not kwargs
            return create(**json.loads(name))
        name = name.lower()
        if name not in registry:
            raise MXNetError(f"{name} is not registered. Known {nickname}s: "
                             f"{sorted(registry)}")
        return registry[name](*args, **kwargs)

    create.__doc__ = f"Create a {nickname} instance from config."
    return create
