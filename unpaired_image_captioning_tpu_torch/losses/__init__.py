"""Training criteria (counterpart of `unpaired_image_captioning_tpu/losses/`)."""
