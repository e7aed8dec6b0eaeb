"""Command-line scripts of the PyTorch port (counterparts of the JAX
package's `scripts/`): `prepro_feats` so far."""
