"""``mx.nd._internal`` (counterpart of ``mxnet_tpu/ndarray/_internal.py``,
reference ``python/mxnet/ndarray/_internal.py``): the registered ops as
callables, looked up at first use so that an op registered after import
is found; ``_internal.<name>`` also finds the op ``_<name>``."""
from ..ops import registry as _registry
from . import _make_op_func


def __getattr__(name: str):
    op = _registry.REGISTRY.get(name)
    if op is None and not name.startswith("_"):
        op = _registry.REGISTRY.get("_" + name)
    if op is None:
        raise AttributeError(f"no registered internal op {name!r}")
    fn = _make_op_func(op, name)
    globals()[name] = fn
    return fn
