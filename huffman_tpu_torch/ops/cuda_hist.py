"""Byte-pair histogram (K6): counterpart of huffman_tpu/ops/pallas_hist.py.

``histogram`` counts the first ``n_valid`` symbols into 65,536 int32 bins:
the CUDA kernel in ``csrc/hist.cu`` for CUDA tensors, ``histogram_plain``
for CPU tensors. Padding past ``n_valid`` never counts, so callers need
not correct bin 0 as the JAX package does after its padded matmul.
"""

from __future__ import annotations

import torch

from ..constants import MAX_SYMBOLS
from ..runtime import kernels


def histogram(symbols: torch.Tensor, n_valid: int) -> torch.Tensor:
    """``symbols``: int16 bits of u16 symbols, any shape (row-major);
    positions at or past ``n_valid`` are padding. Returns (65536,) int32."""
    dev = symbols.device
    kernels.check(symbols, torch.int16, dev, "symbols")
    if not 0 <= n_valid <= symbols.numel():
        raise ValueError(f"n_valid {n_valid} outside [0, {symbols.numel()}]")
    if dev.type == "cuda":
        hist = torch.zeros(MAX_SYMBOLS, dtype=torch.int32, device=dev)
        kernels.launch("histogram", symbols.data_ptr(), n_valid, hist.data_ptr())
        return hist
    if dev.type == "cpu":
        return histogram_plain(symbols, n_valid)
    raise ValueError(f"histogram: unsupported device {dev}")


def histogram_plain(symbols: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version: one scatter-add of ones over the valid
    symbols."""
    idx = symbols.reshape(-1)[:n_valid].to(torch.int64) & 0xFFFF
    hist = torch.zeros(MAX_SYMBOLS, dtype=torch.int64, device=symbols.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx))
    return hist.to(torch.int32)
