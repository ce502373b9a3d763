"""Packed-bitset ops, their hand-written CUDA kernels and plain versions."""
