"""Functional ops of the port."""
from .attention import (flash_attention_qkv_packed, flash_path_available,
                        pair_layout_supported, scaled_dot_product_attention)

__all__ = ["flash_attention_qkv_packed", "flash_path_available",
           "pair_layout_supported", "scaled_dot_product_attention"]
