"""Kernel build and launch runtime of the PyTorch port."""
