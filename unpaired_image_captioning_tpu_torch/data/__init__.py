"""Data loaders of the PyTorch port (counterparts of the JAX package's
`data/`): the caption and NMT loaders, their array files, the feature
workers, the synthetic artifacts and the raw-image loader."""
