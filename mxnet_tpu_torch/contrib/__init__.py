"""Contrib packages of the port."""
from . import amp

__all__ = ["amp"]
