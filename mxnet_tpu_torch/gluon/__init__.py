"""Gluon-side modules of the port: layers, contrib layers, losses and the
model zoo."""
from . import contrib, loss, model_zoo, nn

__all__ = ["contrib", "loss", "model_zoo", "nn"]
