"""``gluon.contrib.estimator`` of the port: the ``Estimator`` fit loop and
its event handlers."""
from . import event_handler
from .estimator import Estimator
from .event_handler import *  # noqa: F401,F403

__all__ = ["Estimator"] + event_handler.__all__
