"""Optimizers of the port."""
from .optimizer import SGD, Adam, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]
