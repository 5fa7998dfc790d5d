"""Attention masks, positional embeddings and the attention kernels."""
