"""The reference ``.compressed`` container and the byte-pair symbol
model: counterpart of huffman_tpu/container/reference_format.py.

A symbol is a little-endian byte pair, ``data[2i] | data[2i+1] << 8``; an
odd input's last byte travels beside the symbols.

Format (little-endian prefix, then one MSB-first bitstream):

* bytes [0:2): unique-symbol count, u16 (0 encodes 65536);
* byte [2]: odd-input flag; if set, byte [3] is the last input byte;
* per unique symbol: the 16-bit symbol, the 8-bit code length, the code;
* the 64-bit input size, least-significant byte first;
* the payload: every symbol's codeword in input order; the final partial
  byte is left-aligned.

The header, the parser and the host decoders are the port's own copies of
the JAX package's, NumPy only. ``compress`` packs the payload on a device
(``ops/encode.py``'s ``pack_stream``), as the JAX package does for
``backend="jax"``: codes from K3 (or the two-table gather past 26 bits),
bit offsets from a device cumsum split into (word, bit) int32 pairs.
``decompress`` is host code, a Python loop: the fallback of
``api.decompress_reference``, which runs the native runtime's decoder
where it is available, as the JAX package does.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np
import torch

from ..bitio import BitReader, BitWriter, bytes_to_u32_msb, u32_msb_to_bytes
from ..codebook import Codebook
from ..constants import MAX_SYMBOLS
from ..ops import encode as enc
from ..ops.cuda_gather import gather_table_codes
from ..ops.histogram import bytes_to_symbols_device
from ..ops.tables import tables_from_codebook
from ..runtime import native
from ..u32 import to_numpy_u32


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
    """Dense 65,536-bin int64 histogram of u16 symbols: the native
    runtime's threaded loop where it is available, NumPy otherwise."""
    if native.available():
        return native.histogram(np.ascontiguousarray(symbols, dtype="<u2").view(np.uint8))
    return np.bincount(symbols, minlength=MAX_SYMBOLS).astype(np.int64)


def compress(data: bytes, device: torch.device) -> bytes:
    """The reference ``.compressed`` container of ``data``, with the
    unlimited Huffman code of its byte pairs and the payload packed on
    ``device``."""
    symbols, is_odd, last_byte = bytes_to_symbols(data)
    freqs = histogram_host(symbols)
    codebook = Codebook.from_frequencies(freqs)

    header = BitWriter()
    n_unique = codebook.n_unique
    emit_dummy = n_unique == 0
    count_field = 1 if emit_dummy else (n_unique & 0xFFFF)  # 65536 wraps to 0
    header.write_bytes_aligned(
        bytes([count_field & 0xFF, (count_field >> 8) & 0xFF, 1 if is_odd else 0])
    )
    if is_odd:
        header.write_bytes_aligned(bytes([last_byte]))
    if emit_dummy:
        # No symbols; the reference decoder still reads one table entry.
        header.write(0, 16)
        header.write(1, 8)
        header.write(0, 1)
    else:
        # Emission order: ascending (frequency, symbol).
        present = codebook.sym_order.astype(np.int64)
        order = np.lexsort((present, freqs[present]))
        for sym in present[order]:
            length = int(codebook.lengths[sym])
            header.write(int(sym), 16)
            header.write(length, 8)
            header.write(int(codebook.codes[sym]), length)
    for i in range(8):
        header.write((len(data) >> (8 * i)) & 0xFF, 8)

    head = header.getvalue()
    if not symbols.size:
        return head
    # The payload starts at the header's bit position, so its first byte
    # is the OR of the header's last partial byte and the payload's.
    start_bit = header.bit_position
    words, nbits = _pack_stream_device(symbols, codebook, start_bit, device)
    payload = bytearray(u32_msb_to_bytes(words, nbits))
    boundary = start_bit >> 3
    payload[:boundary] = head[:boundary]
    if start_bit & 7:
        payload[boundary] |= head[boundary]
    return bytes(payload)


def _pack_stream_device(symbols: np.ndarray, codebook: Codebook, start_bit: int,
                        device: torch.device) -> tuple[np.ndarray, int]:
    """The payload's big-endian u32 words, the first code at ``start_bit``,
    packed on ``device``, and the stream's bit total. Global bit offsets
    can pass 2**31, so they reach ``pack_stream`` as (word, bit) int32
    pairs of an int64 cumsum."""
    tables = tables_from_codebook(codebook, device)
    raw = torch.from_numpy(symbols.astype("<u2").view(np.uint8)).to(device)
    codes, lens = gather_table_codes(bytes_to_symbols_device(raw), tables, symbols.size)
    lens64 = lens.to(torch.int64)
    offsets = torch.cumsum(lens64, dim=0) - lens64 + start_bit
    nbits = int(offsets[-1] + lens64[-1])
    words = enc.pack_stream(
        codes, lens, (offsets >> 5).to(torch.int32), (offsets & 31).to(torch.int32),
        (nbits + 31) >> 5,
    )
    return to_numpy_u32(words), nbits


@dataclass(frozen=True)
class ReferenceHeader:
    symbols: np.ndarray      # (n,) uint16 in table order
    lengths: np.ndarray      # (n,) int64
    codes: np.ndarray        # (n,) uint64 (the format allows up to 64 bits)
    file_size: int
    is_odd: bool
    last_byte: int
    payload_bit_offset: int  # absolute bit offset of the payload in the blob


def parse_header(blob: bytes) -> ReferenceHeader:
    if len(blob) < 3:
        raise ValueError("truncated reference container")
    count = blob[0] | (blob[1] << 8)
    if count == 0:
        count = 65536
    is_odd = bool(blob[2])
    pos = 3
    last_byte = 0
    if is_odd:
        if len(blob) < 4:
            raise ValueError("truncated reference container")
        last_byte = blob[3]
        pos = 4
    reader = BitReader(blob, pos * 8)
    syms = np.empty(count, dtype=np.uint16)
    lens = np.empty(count, dtype=np.int64)
    codes = np.empty(count, dtype=np.uint64)
    for i in range(count):
        syms[i] = reader.read(16)
        length = reader.read(8)
        if length == 0:
            length = 65536
        if length > 64:
            raise ValueError(f"unsupported code length {length}")
        lens[i] = length
        codes[i] = reader.read(length)
    file_size = 0
    for i in range(8):
        file_size |= reader.read(8) << (8 * i)
    return ReferenceHeader(
        symbols=syms, lengths=lens, codes=codes, file_size=file_size,
        is_odd=is_odd, last_byte=last_byte,
        payload_bit_offset=reader.bit_position,
    )


def decode_payload_host(header: ReferenceHeader, blob: bytes) -> np.ndarray:
    """Decode the payload of any prefix code (canonical or not) on the
    host: the left-justified codewords of a prefix code are totally
    ordered, and the codeword matching a 32-bit peek P is the greatest one
    <= P."""
    n_pairs = header.file_size // 2
    if header.lengths.size and header.lengths.max() > 32:
        return _decode_payload_host64(header, blob, n_pairs)
    lj = (header.codes.astype(np.uint64) << (32 - header.lengths.astype(np.uint64))) & np.uint64(
        0xFFFFFFFF
    )
    order = np.argsort(lj, kind="stable")
    lj_sorted = lj[order]
    len_sorted = header.lengths[order]
    sym_sorted = header.symbols[order]

    words = bytes_to_u32_msb(blob).astype(np.uint64)
    padded = np.concatenate([words, np.zeros(2, dtype=np.uint64)])
    out = np.empty(n_pairs, dtype=np.uint16)
    pos = header.payload_bit_offset
    for i in range(n_pairs):
        w = pos >> 5
        sh = pos & 31
        window = (padded[w] << np.uint64(32)) | padded[w + 1]
        peek = (window >> np.uint64(32 - sh)) & np.uint64(0xFFFFFFFF)
        idx = int(np.searchsorted(lj_sorted, peek, side="right")) - 1
        if idx < 0:
            # Only an incomplete foreign code with no all-zeros codeword.
            raise ValueError("corrupt payload: bits match no codeword")
        out[i] = sym_sorted[idx]
        pos += int(len_sorted[idx])
    return out


def _decode_payload_host64(header: ReferenceHeader, blob: bytes, n_pairs: int) -> np.ndarray:
    """``decode_payload_host`` with a 64-bit window, for foreign containers
    with code lengths of 33..64 bits (the format allows them)."""
    lj = [
        (int(c) << (64 - int(l))) & 0xFFFFFFFFFFFFFFFF
        for c, l in zip(header.codes, header.lengths)
    ]
    order = sorted(range(len(lj)), key=lj.__getitem__)
    lj_sorted = [lj[i] for i in order]
    len_sorted = [int(header.lengths[i]) for i in order]
    sym_sorted = [int(header.symbols[i]) for i in order]

    padded = blob + b"\x00" * 16
    out = np.empty(n_pairs, dtype=np.uint16)
    pos = header.payload_bit_offset
    for i in range(n_pairs):
        byte = pos >> 3
        window = int.from_bytes(padded[byte : byte + 9], "big")
        peek = (window >> (72 - 64 - (pos & 7))) & 0xFFFFFFFFFFFFFFFF
        idx = bisect.bisect_right(lj_sorted, peek) - 1
        if idx < 0:
            raise ValueError("corrupt payload: bits match no codeword")
        out[i] = sym_sorted[idx]
        pos += len_sorted[idx]
    return out


def decompress(blob: bytes) -> bytes:
    header = parse_header(blob)
    symbols = decode_payload_host(header, blob)
    return symbols_to_bytes(symbols, header.is_odd, header.last_byte)
