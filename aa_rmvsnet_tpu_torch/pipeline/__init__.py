"""Inference, fusion, training and checkpoints."""
