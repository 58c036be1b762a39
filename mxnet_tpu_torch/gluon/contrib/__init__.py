"""Contrib layers and the Estimator of the port."""
from . import estimator, nn

__all__ = ["estimator", "nn"]
