"""Gluon-side modules of the port (model zoo)."""
from . import model_zoo

__all__ = ["model_zoo"]
