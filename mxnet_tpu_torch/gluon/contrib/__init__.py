"""Contrib layers of the port."""
from . import nn

__all__ = ["nn"]
