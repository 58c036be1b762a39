"""Gluon of the port: ``Parameter``/``ParameterDict``, ``Block``/
``HybridBlock``/``SymbolBlock``, ``Trainer``, the layers, contrib layers,
losses and the model zoo."""
from . import contrib, loss, model_zoo, nn
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Constant", "DeferredInitializationError",
           "Parameter", "ParameterDict", "Trainer", "contrib", "loss",
           "model_zoo", "nn"]
