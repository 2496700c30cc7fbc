"""Byte pairs to symbols on the device: counterpart of
``bytes_to_symbols_device`` in huffman_tpu/ops/histogram.py.

Little-endian byte pairs ARE the u16 symbols, so a reinterpreting view of
the uploaded bytes gives them with no copy. The port carries symbols as
int16 bit patterns; the kernels read them as ``uint16_t``.
"""

from __future__ import annotations

import torch


def bytes_to_symbols_device(data: torch.Tensor) -> torch.Tensor:
    """(2n,) uint8 bytes -> (n,) int16 bits of the u16 symbols
    ``data[2i] | data[2i+1] << 8`` (a view, no copy)."""
    if data.dtype != torch.uint8 or data.dim() != 1 or data.numel() % 2:
        raise ValueError("expected a 1-D uint8 tensor of even length")
    return data.contiguous().view(torch.int16)
