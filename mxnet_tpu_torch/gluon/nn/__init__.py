"""Gluon layers of the port."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridLambda, HybridSequential, Lambda, LayerNorm,
                           Sequential)
from .conv_layers import AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "HybridLambda", "HybridSequential", "Lambda",
           "LayerNorm", "Sequential", "AvgPool2D", "Conv2D",
           "GlobalAvgPool2D", "MaxPool2D"]
