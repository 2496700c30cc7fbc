"""The benchmark of the PyTorch and CUDA codec: see run.py."""
