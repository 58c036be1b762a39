"""Model zoo of the port."""
from . import language

__all__ = ["language"]
