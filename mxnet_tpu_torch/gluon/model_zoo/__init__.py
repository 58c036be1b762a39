"""Model zoo of the port: vision and language models, the local weight
store, and ``get_model``."""
from . import language, model_store, vision
from .vision import get_model

__all__ = ["language", "model_store", "vision", "get_model"]
