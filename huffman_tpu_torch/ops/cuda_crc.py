"""CRC32 of decoded words on the card (K11): the check ``decompress`` makes.

``crc32_words(words, n_bytes)`` is zlib's CRC32 of the first ``n_bytes``
bytes of an int32 tensor's little-endian bytes, as a (1,) int32 tensor on
the tensor's device (the u32 CRC's bits): the CUDA kernel in
``csrc/crc32.cu`` for CUDA tensors, ``crc32_words_plain`` for CPU tensors.
It replaces no TPU kernel: the JAX package checks a container's CRC32 with
zlib on the host, over the bytes decompress returns.

Both rest on CRC32 being linear over GF(2). Write raw(M) for the CRC of M
from 0 without the final inversion, and x^k for the polynomial x^k modulo
zlib's (reflected) polynomial, in zlib's bit order (bit 31 is x^0). Then
raw(A || B) = raw(A) x^(8|B|) ^ raw(B), leading zero bytes leave raw
unchanged, and zlib's CRC of n bytes is ~(raw(M) ^ ~0 x^(8n)). So the
bytes may be folded in pieces, each piece's raw CRC moved to the end by
one product (``multmodp``) with a power of x (``x8nmodp``), and the pieces
XORed.
"""

from __future__ import annotations

import torch

from ..runtime import kernels

POLY = 0xEDB88320  # zlib's CRC32 polynomial, reflected
ONE = 1 << 31  # the polynomial 1 in zlib's bit order
# The bytes one block of csrc/crc32.cu folds (kTileBytes): the kernel needs
# one int32 of scratch for each started tile.
TILE_BYTES = 32768
# The plain version's pieces: rows of this many bytes, folded side by side.
PLAIN_CHUNK_BYTES = 512


def multmodp(a: int, b: int) -> int:
    """a(x) b(x) modulo the CRC polynomial (zlib's ``multmodp``)."""
    p = 0
    for _ in range(32):
        if a & ONE:
            p ^= b
        a = (a << 1) & 0xFFFFFFFF
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


def x8nmodp(n: int) -> int:
    """x^(8n) modulo the CRC polynomial: n zero bytes' shift, by squaring."""
    p, sq = ONE, 1 << 23  # x^0; x^8
    while n:
        if n & 1:
            p = multmodp(p, sq)
        sq = multmodp(sq, sq)
        n >>= 1
    return p


def crc32_words(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """zlib's CRC32 of the first ``n_bytes`` bytes of ``words`` (a
    contiguous int32 tensor), as a (1,) int32 tensor on its device. On a
    CUDA device the result is not read back: the caller copies it with
    whatever else it brings down."""
    dev = words.device
    kernels.check(words, torch.int32, dev, "words")
    if not 0 <= n_bytes <= 4 * words.numel():
        raise ValueError(f"n_bytes {n_bytes} outside [0, {4 * words.numel()}]")
    if dev.type == "cuda":
        capacity = -(-n_bytes // TILE_BYTES)
        scratch = torch.empty(1 + capacity, dtype=torch.int32, device=dev)  # the CRC, then one a tile
        kernels.launch("crc32_words", words.data_ptr(), n_bytes, scratch.data_ptr(), capacity)
        return scratch[:1]
    if dev.type == "cpu":
        return crc32_words_plain(words, n_bytes)
    raise ValueError(f"crc32_words: unsupported device {dev}")


def _byte_table(device) -> torch.Tensor:
    t = torch.arange(256, dtype=torch.int64, device=device)
    for _ in range(8):
        t = (t >> 1) ^ (POLY * (t & 1))
    return t


def _times(v: torch.Tensor, c: int) -> torch.Tensor:
    """Each u32 of ``v`` (int64) times the constant ``c``, modulo the
    polynomial: the bits of ``c`` from x^0 up."""
    p = torch.zeros_like(v)
    for i in range(32):
        if c >> (31 - i) & 1:
            p ^= v
        v = (v >> 1) ^ (POLY * (v & 1))
    return p


def _xor_all(v: torch.Tensor) -> int:
    bits = torch.arange(32, device=v.device)
    parity = ((v[:, None] >> bits) & 1).sum(dim=0) & 1
    return int((parity << bits).sum())


def crc32_words_plain(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Plain PyTorch version: the bytes, led by zeros to whole rows of
    ``PLAIN_CHUNK_BYTES``, folded a byte at a time in every row at once
    (zlib's byte table, from 0); each row's raw CRC moved past the rows
    after it by the squares of x^(8 ``PLAIN_CHUNK_BYTES``) the bits of
    their count pick; the rows XORed; then zlib's inversions."""
    dev = words.device
    data = words.reshape(-1).view(torch.uint8)[:n_bytes].to(torch.int64)
    rows = -(-n_bytes // PLAIN_CHUNK_BYTES)
    lead = torch.zeros(rows * PLAIN_CHUNK_BYTES - n_bytes, dtype=torch.int64, device=dev)
    chunks = torch.cat([lead, data]).reshape(rows, PLAIN_CHUNK_BYTES)
    table = _byte_table(dev)
    raw = torch.zeros(rows, dtype=torch.int64, device=dev)
    for j in range(PLAIN_CHUNK_BYTES):
        raw = table[(raw ^ chunks[:, j]) & 0xFF] ^ (raw >> 8)
    after = torch.arange(rows - 1, -1, -1, device=dev)
    power = x8nmodp(PLAIN_CHUNK_BYTES)
    while rows and int(after.max()):
        raw = torch.where((after & 1).bool(), _times(raw, power), raw)
        after >>= 1
        power = multmodp(power, power)
    body = _xor_all(raw) if rows else 0
    crc = body ^ multmodp(0xFFFFFFFF, x8nmodp(n_bytes)) ^ 0xFFFFFFFF
    return torch.tensor([crc - (1 << 32) if crc >> 31 else crc], dtype=torch.int32, device=dev)
