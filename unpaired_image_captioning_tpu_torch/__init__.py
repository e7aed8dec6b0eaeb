"""PyTorch port of the unpaired image captioning system, for NVIDIA Hopper.

The JAX package `unpaired_image_captioning_tpu` beside it is the reference.
This package keeps its module layout, public names and parameter layouts
(fused `[D+H, G*H]` cell weights, batch-major caption state, `[B*K, V]`
beam rows) and imports torch, never jax and nothing of the reference
package: the host code it needs (config, constants, vocab, utils.text,
serve's MicroBatcher and HTTP front end) is its own copy.

Kernels (`kernels/`, CUDA C++ in `csrc/`) run for CUDA tensors; CPU
tensors take their plain PyTorch versions. The entry points (`models.setup`,
the `from_config` constructors, `make_nmt_model`, `train.trainer.Trainer`)
build on the card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
