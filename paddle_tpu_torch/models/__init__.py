"""Models of the port."""
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_tiny",
           "LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_7b",
           "llama_tiny"]
