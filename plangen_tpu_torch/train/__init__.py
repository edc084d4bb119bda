"""Multi-task training: losses, the train step, AdamW, checkpoints, the
Trainer (port of `plangen_tpu/train/`)."""
