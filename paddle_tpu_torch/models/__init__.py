"""Models of the port."""
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_tiny"]
