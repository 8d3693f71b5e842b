"""Resharding's pieces the port has so far: the block wire format
(``snapshot.encode_block`` / ``decode_block``) that the serving KV pool
moves blocks in."""
from .snapshot import decode_block, encode_block

__all__ = ["decode_block", "encode_block"]
