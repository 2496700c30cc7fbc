"""Table lookups (K2, K3): counterpart of huffman_tpu/ops/pallas_gather.py.

* ``gather_u16_pairs`` (K2): both 16-bit halves of each packed rank word
  index the canonical symbol table, giving packed symbol pairs: the
  decoder's rank mode. Indices past the table read its last entry.
* ``gather_codes`` (K3): symbol -> (code, length) through the dense
  ``len << 26 | code`` table, with the encoder's valid mask applied. The
  TPU needed two kernels for this one function (a row-displacement table
  and a packed-16 dense table); on the GPU the dense table is enough.

Each wrapper launches its CUDA kernel (``csrc/gather.cu``) for CUDA
tensors and its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from ..u32 import narrow, widen

CODE_MASK = (1 << 26) - 1


def gather_u16_pairs(packed_idx: torch.Tensor, sym_order: torch.Tensor) -> torch.Tensor:
    """``packed_idx``: int32 words ``lo | hi << 16`` of any shape;
    ``sym_order``: (n,) int16 bits of the u16 table, n >= 1. Returns int32
    words ``table[lo] | table[hi] << 16`` in ``packed_idx``'s shape."""
    dev = packed_idx.device
    kernels.check(packed_idx, torch.int32, dev, "packed_idx")
    kernels.check(sym_order, torch.int16, dev, "sym_order")
    if sym_order.numel() < 1:
        raise ValueError("gather_u16_pairs needs a non-empty table")
    if dev.type == "cuda":
        out = torch.empty_like(packed_idx)
        kernels.launch(
            "gather_u16_pairs", packed_idx.data_ptr(), packed_idx.numel(),
            sym_order.data_ptr(), sym_order.numel(), out.data_ptr(),
        )
        return out
    if dev.type == "cpu":
        return gather_u16_pairs_plain(packed_idx, sym_order)
    raise ValueError(f"gather_u16_pairs: unsupported device {dev}")


def gather_u16_pairs_plain(packed_idx: torch.Tensor, sym_order: torch.Tensor) -> torch.Tensor:
    u = widen(packed_idx)
    table = sym_order.to(torch.int64) & 0xFFFF
    last = table.numel() - 1
    lo = table[(u & 0xFFFF).clamp(max=last)]
    hi = table[(u >> 16).clamp(max=last)]
    return narrow(lo | (hi << 16))


def gather_codes(
    symbols: torch.Tensor,  # int16 bits of u16 symbols, any shape
    table: torch.Tensor,    # (65536,) int32 bits of len << 26 | code
    n_valid: int,           # positions (row-major) at or past this are padding
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes int32, lens int32) in ``symbols``' shape; padding
    positions get code 0 and length 0."""
    dev = symbols.device
    kernels.check(symbols, torch.int16, dev, "symbols")
    kernels.check(table, torch.int32, dev, "table")
    if table.numel() != 1 << 16:
        raise ValueError("gather_codes needs the dense 65,536-entry table")
    if dev.type == "cuda":
        codes = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        lens = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        kernels.launch(
            "gather_codes", symbols.data_ptr(), symbols.numel(), n_valid,
            table.data_ptr(), codes.data_ptr(), lens.data_ptr(),
        )
        return codes, lens
    if dev.type == "cpu":
        return gather_codes_plain(symbols, table, n_valid)
    raise ValueError(f"gather_codes: unsupported device {dev}")


def gather_codes_plain(
    symbols: torch.Tensor, table: torch.Tensor, n_valid: int
) -> tuple[torch.Tensor, torch.Tensor]:
    packed = widen(table)[symbols.to(torch.int64) & 0xFFFF]
    pos = torch.arange(symbols.numel(), device=symbols.device).reshape(symbols.shape)
    packed = torch.where(pos < n_valid, packed, 0)
    return (packed & CODE_MASK).to(torch.int32), (packed >> 26).to(torch.int32)
