"""Tensor ops of the port."""
