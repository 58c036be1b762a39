"""Language models of the port."""
from .llama import (LlamaAttention, LlamaBlock, LlamaFFN, LlamaModel, RMSNorm,
                    llama_7b, llama_tiny)

__all__ = ["RMSNorm", "LlamaAttention", "LlamaFFN", "LlamaBlock", "LlamaModel",
           "llama_tiny", "llama_7b"]
