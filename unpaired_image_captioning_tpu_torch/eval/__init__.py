"""Evaluation of the PyTorch port (counterpart of the JAX package's
`eval/`): the caption metrics and the val loop of the training CLI."""
