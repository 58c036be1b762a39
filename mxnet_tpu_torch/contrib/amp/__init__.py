"""Mixed precision for the port: bf16 model conversion."""
from .amp import convert_block

__all__ = ["convert_block"]
