"""Data loaders of the PyTorch port (counterparts of the JAX package's
`data/`): the raw-image loader so far."""
