"""Language models of the port."""
from .bert import (BERTForPretraining, BERTModel, bert_12_768_12,
                   bert_24_1024_16, get_bert)
from .llama import (LlamaAttention, LlamaBlock, LlamaFFN, LlamaModel, RMSNorm,
                    llama_7b, llama_tiny)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["RMSNorm", "LlamaAttention", "LlamaFFN", "LlamaBlock", "LlamaModel",
           "llama_tiny", "llama_7b", "MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder", "BERTModel",
           "BERTForPretraining", "get_bert", "bert_12_768_12",
           "bert_24_1024_16"]
