"""Command-line scripts of the PyTorch port (counterparts of the JAX
package's `scripts/`): the caption and NMT preprocessing, the bottom-up
features, back-translation, image features, n-gram caches, file
conversion and reference-checkpoint migration."""
