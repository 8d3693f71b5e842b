"""Functional ops of the port."""
from .attention import (flash_at_any_length, flash_attention,
                        flash_attention_qkv_packed, flash_path_available,
                        pair_layout_supported, scaled_dot_product_attention)
from .common import dropout
from .norm import add_dropout_ln, layer_norm

__all__ = ["flash_attention", "flash_attention_qkv_packed",
           "flash_path_available", "flash_at_any_length",
           "pair_layout_supported",
           "scaled_dot_product_attention", "dropout", "layer_norm",
           "add_dropout_ln"]
