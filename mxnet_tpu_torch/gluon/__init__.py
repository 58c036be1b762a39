"""Gluon of the port: ``Parameter``/``ParameterDict``, ``Block``/
``HybridBlock``/``SymbolBlock``, ``Trainer``, the layers, contrib layers,
losses, the model zoo and the data API."""
from . import contrib, data, loss, model_zoo, nn
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Constant", "DeferredInitializationError",
           "Parameter", "ParameterDict", "Trainer", "contrib", "data", "loss",
           "model_zoo", "nn"]
