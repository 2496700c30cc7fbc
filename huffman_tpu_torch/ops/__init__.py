"""Device ops of the PyTorch port: each ``cuda_*`` module is the twin of
the JAX package's ``pallas_*`` module of the same suffix."""
