"""Model zoo of the port."""
from . import language, vision

__all__ = ["language", "vision"]
