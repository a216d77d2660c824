"""Checkpoint conversion between dcpt_tpu (flax) and this package (PyTorch)."""
