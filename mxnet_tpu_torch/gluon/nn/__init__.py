"""Gluon layers of the port."""
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU, PReLU,
                          Swish)
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, Sequential,
                           SyncBatchNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "BatchNorm", "SyncBatchNorm", "InstanceNorm", "Dense",
           "Dropout", "Embedding", "Flatten", "GroupNorm", "HybridLambda",
           "HybridSequential", "Lambda", "LayerNorm", "Sequential",
           "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]
