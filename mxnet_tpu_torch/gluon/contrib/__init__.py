"""Contrib layers, samplers and the Estimator of the port
(``gluon/contrib/rnn.py`` waits for ``gluon/rnn``, ROADMAP A15)."""
from . import cnn, data, estimator, nn

__all__ = ["estimator", "nn", "cnn", "data"]
