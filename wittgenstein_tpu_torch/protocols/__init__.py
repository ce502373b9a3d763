"""Batched protocols: Handel on the bitset-aggregation base."""
