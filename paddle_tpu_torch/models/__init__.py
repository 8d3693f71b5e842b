"""Models of the port."""
from .bert import (BertConfig, BertForPreTraining, BertModel, bert_base,
                   bert_tiny)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_tiny)

__all__ = ["BertConfig", "BertForPreTraining", "BertModel", "bert_base",
           "bert_tiny", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "gpt_tiny", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama_7b", "llama_tiny"]
