"""Packed-bitset ops, their hand-written CUDA kernels and plain versions."""

from .bitops import block_mask, level_block_mask, popcount_words, xor_shuffle

__all__ = ["block_mask", "level_block_mask", "popcount_words", "xor_shuffle"]
