"""What the vision zoo's models share: the symbolic form of a model whose
``forward`` only composes its children, a concatenation for tensors and
Symbols alike, and where a model built with ``device`` (or ``ctx``) puts
the parameters whose widths wait for the first forward."""
from __future__ import annotations

from ....context import Context, resolve_device
from ...block import HybridBlock
from ...contrib.nn import _concat as concat

__all__ = ["ZooBlock", "concat"]


class ZooBlock(HybridBlock):
    """A zoo block whose ``forward`` composes its children, so it serves
    tensors (and NDArrays, through the Gluon boundary) and Symbols alike:
    ``hybrid_forward`` is that ``forward``."""

    def hybrid_forward(self, F, x):
        return self.forward(x)

    def _defer_to(self, device=None, ctx=None):
        """With ``device`` or ``ctx``, initialize every parameter (the
        default initializer; a later ``initialize`` overrides it) on that
        device, where the first forward allocates the deferred ones;
        without either, leave initialization to the caller, as the JAX
        package does."""
        if device is None and ctx is None:
            return
        dev = ctx.torch_device() if device is None else resolve_device(
            device)
        self.collect_params().initialize(ctx=Context.of(dev))
