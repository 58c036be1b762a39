"""Optimizers of the port."""
from .optimizer import (SGD, Adam, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "get_updater",
           "register"]
