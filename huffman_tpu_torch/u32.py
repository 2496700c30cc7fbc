"""Unsigned 32-bit helpers for the plain PyTorch versions of the kernels.

PyTorch's ``uint32`` tensors lack shifts, compares, addition and ``max``
on the CPU, and its ``int32`` right shift is arithmetic, while the codec
needs logical u32 shifts and unsigned compares. The plain versions
therefore carry u32 values in ``int64`` tensors kept in ``[0, 2**32)``.
Tensors handed to the CUDA kernels are ``int32`` bit patterns, which the
kernels read as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.profiling import copied

MASK32 = 0xFFFFFFFF


def widen(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return bits.to(torch.int64) & MASK32


def narrow(values: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of their low 32 bits."""
    v = values & MASK32
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def shl(x: torch.Tensor, s) -> torch.Tensor:
    """Logical left shift of int64 u32 values, wrapped to 32 bits."""
    return (x << s) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 u32 values (the SWAR count; PyTorch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def from_numpy_u32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy u32 values -> int32 bit-pattern tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
    host = torch.from_numpy(arr.copy())
    return copied(host, host.to(device))


def to_numpy_u32(bits: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy u32 array on the host."""
    bits = bits.detach()
    return copied(bits, bits.cpu()).contiguous().numpy().view(np.uint32)
