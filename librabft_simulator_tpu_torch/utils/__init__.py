"""Hashing, quantile tables and batched write helpers."""
