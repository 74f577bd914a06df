"""Inference driver."""
