"""Gluon layers of the port (the training slice's)."""
from .activations import Activation
from .basic_layers import BatchNorm, Dense, Flatten, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Dense", "Flatten", "HybridSequential",
           "Conv2D", "GlobalAvgPool2D", "MaxPool2D"]
