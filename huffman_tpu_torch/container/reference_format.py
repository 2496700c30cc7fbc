"""Byte-pair symbol model on the host: the port's own copy of
``bytes_to_symbols``, ``symbols_to_bytes`` and ``histogram_host`` from
huffman_tpu/container/reference_format.py, NumPy only.

A symbol is a little-endian byte pair, ``data[2i] | data[2i+1] << 8``; an
odd input's last byte travels beside the symbols.
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_SYMBOLS


def bytes_to_symbols(data: bytes | np.ndarray) -> tuple[np.ndarray, bool, int]:
    """Split raw bytes into 16-bit little-endian byte-pair symbols.
    Returns (symbols, is_odd, last_byte)."""
    if isinstance(data, (bytes, bytearray)):
        buf = np.frombuffer(data, dtype=np.uint8)
    else:
        buf = np.asarray(data, dtype=np.uint8)
    is_odd = buf.size % 2 == 1
    last_byte = int(buf[-1]) if is_odd else 0
    pairs = buf[: buf.size - (buf.size % 2)]
    symbols = pairs.view("<u2").astype(np.uint16)
    return symbols, is_odd, last_byte


def symbols_to_bytes(symbols: np.ndarray, is_odd: bool, last_byte: int) -> bytes:
    out = np.asarray(symbols, dtype="<u2").tobytes()
    if is_odd:
        out += bytes([last_byte])
    return out


def histogram_host(symbols: np.ndarray) -> np.ndarray:
    """Dense 65,536-bin int64 histogram of u16 symbols."""
    return np.bincount(symbols, minlength=MAX_SYMBOLS).astype(np.int64)
