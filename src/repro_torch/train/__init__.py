"""Optimizers, metrics and the training loop."""
