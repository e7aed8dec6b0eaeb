"""PyTorch port of the unpaired image captioning system, for NVIDIA Hopper.

The JAX package `unpaired_image_captioning_tpu` beside it is the reference.
This package keeps its module layout, public names and parameter layouts
(fused `[D+H, G*H]` cell weights, batch-major caption state, `[B*K, V]`
beam rows), imports torch and never jax, and reuses the reference
package's jax-free host modules (config, constants, vocab, utils.text,
serve's MicroBatcher and HTTP front end) by import.

Kernels (`kernels/`, CUDA C++ in `csrc/`) run for CUDA tensors; CPU
tensors take their plain PyTorch versions.
"""

__version__ = "0.1.0"
