"""Command-line entry points of the PyTorch port (counterparts of the JAX
package's `cli/`): `preprocess`, `train`, `translate` and the eval CLIs."""
