"""Optimizers of the port."""
from .optimizer import SGD, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "create", "register"]
