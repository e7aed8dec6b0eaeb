"""Tensor ops of the PyTorch port (counterparts of the JAX package's ops)."""
