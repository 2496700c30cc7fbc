"""MSB-first bit I/O on the host: the port's own copy of what the
reference container needs from huffman_tpu/bitio.py (``BitWriter``,
``BitReader``, ``u32_msb_to_bytes``, ``bytes_to_u32_msb``), NumPy only.

Bit p of a stream lives in word ``p >> 5`` at bit position ``31 - (p &
31)``: big-endian words.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Scalar MSB-first bit writer (header-sized payloads only)."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bit accumulator, MSB-first
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        if value < 0 or value >> nbits:
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_bytes_aligned(self, data: bytes) -> None:
        """Append raw bytes; requires the cursor to be byte-aligned."""
        if self._nbits != 0:
            raise ValueError("bit cursor not byte-aligned")
        self._buf.extend(data)

    @property
    def bit_position(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def getvalue(self) -> bytes:
        """The byte stream; a trailing partial byte is left-aligned
        (zero-padded on the right)."""
        out = bytearray(self._buf)
        if self._nbits:
            out.append((self._acc << (8 - self._nbits)) & 0xFF)
        return bytes(out)


class BitReader:
    """Scalar MSB-first bit reader (header-sized payloads only)."""

    def __init__(self, data: bytes, bit_offset: int = 0) -> None:
        self._data = data
        self._pos = bit_offset

    def read(self, nbits: int) -> int:
        end = self._pos + nbits
        if end > len(self._data) * 8:
            raise EOFError("bitstream exhausted")
        value = 0
        pos = self._pos
        remaining = nbits
        while remaining > 0:
            byte = self._data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, remaining)
            chunk = (byte >> (avail - take)) & ((1 << take) - 1)
            value = (value << take) | chunk
            pos += take
            remaining -= take
        self._pos = pos
        return value

    @property
    def bit_position(self) -> int:
        return self._pos


def u32_msb_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    """Big-endian u32 words -> byte stream truncated to ceil(nbits/8) bytes."""
    nbytes = (nbits + 7) >> 3
    return words.astype(">u4").tobytes()[:nbytes]


def bytes_to_u32_msb(data: bytes) -> np.ndarray:
    """Byte stream -> big-endian u32 word array (zero padded)."""
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\x00" * pad
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)
