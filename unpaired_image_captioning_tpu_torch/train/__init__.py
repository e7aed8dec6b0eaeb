"""Training: the optimizer transforms and schedules, and the trainer
(counterpart of `unpaired_image_captioning_tpu/train/`)."""
