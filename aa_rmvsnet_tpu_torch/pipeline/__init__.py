"""Inference and training drivers, and checkpoints."""
