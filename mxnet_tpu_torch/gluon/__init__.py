"""Gluon of the port: ``Parameter``/``ParameterDict``, ``Block``/
``HybridBlock``/``SymbolBlock``, ``Trainer``, the layers, contrib layers,
losses, the model zoo, the data API, the fused RNN layers (``rnn``) and
``utils``."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from .utils import split_and_load, split_data

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Constant", "DeferredInitializationError",
           "Parameter", "ParameterDict", "Trainer", "contrib", "data", "loss",
           "model_zoo", "nn", "rnn", "split_and_load", "split_data", "utils"]
