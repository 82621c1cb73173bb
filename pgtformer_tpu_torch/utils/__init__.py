"""Utilities of the training run: image helpers, logging, checkpoints."""
