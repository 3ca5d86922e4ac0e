"""Dataset IO, prefix augmentation and the host input pipeline."""
