"""Gluon layers of the port (the training slices')."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridSequential, LayerNorm)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "HybridSequential", "LayerNorm", "Conv2D",
           "GlobalAvgPool2D", "MaxPool2D"]
