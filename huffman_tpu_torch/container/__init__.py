"""Container formats of the PyTorch port (HTPU v2 only so far)."""
