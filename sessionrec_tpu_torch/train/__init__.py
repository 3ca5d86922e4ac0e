"""Optimizer, training loop and the end-to-end session."""
