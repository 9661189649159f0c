"""Checkpoint / resume and convergence-logging utilities of the PyTorch port."""
