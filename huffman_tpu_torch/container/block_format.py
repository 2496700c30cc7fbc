"""HTPU v2 container on the device: counterpart of the device branches of
huffman_tpu/container/block_format.py.

The wire format, the header, the codebook and the stream layout are the
JAX package's own host code, imported read-only: ``_build_header``,
``_codebook_to_header``, ``_emit_streams``, ``ParsedContainer`` and
``_host_codebook``. This module ports what ran on the TPU:

* encode: bytes -> byte-pair symbols -> (code, length) gather (K3) ->
  protocol lengths and per-group word totals -> lane pack (K4) and stream
  assembly, the path of ``_encode_streams_jax``;
* decode: group decode (K1), rank -> symbol pairs (K2) for alphabets past
  the in-kernel tier, and the block-major reorder of ``_postpack_v2``.

Containers are byte-identical to ``huffman_tpu.compress(data,
backend="numpy")``: the codebook is the same host-built package-merge code
and the streams follow the same decode protocol.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from huffman_tpu.codebook import Codebook
from huffman_tpu.constants import (
    DEFAULT_BLOCK_SYMBOLS,
    DEFAULT_MAX_CODE_LEN,
    GROUP_LANES,
)
from huffman_tpu.container import interleave as il
from huffman_tpu.container.block_format import (
    _HEADER_BYTES,
    ParsedContainer,
    _bucket_words,
    _build_header,
    _codebook_to_header,
    _emit_streams,
    _host_codebook,
)
from huffman_tpu.container.reference_format import (
    bytes_to_symbols,
    histogram_host,
    symbols_to_bytes,
)

from ..ops.cuda_decode import TRANSLATE_MAX_ALPHABET, decode_groups
from ..ops.cuda_encode import pack_streams
from ..ops.cuda_gather import gather_codes, gather_u16_pairs
from ..ops.tables import PACKED_MAX_LEN, Tables, tables_from_codebook
from ..u32 import from_numpy_u32, to_numpy_u32


# --------------------------------------------------------------------------
# compress
# --------------------------------------------------------------------------

def compress(
    data: bytes,
    device: torch.device,
    block_symbols: int = DEFAULT_BLOCK_SYMBOLS,
    max_code_len: int | None = DEFAULT_MAX_CODE_LEN,
    codebook: Codebook | None = None,
) -> bytes:
    """HTPU v2 container of ``data``, payload encoded on ``device``. The
    codebook is built on the host (length-limited package-merge at
    ``max_code_len``; None for the unlimited Huffman code) unless given."""
    data = bytes(data)
    if len(data) > (1 << 32):
        raise ValueError("input exceeds 4 GiB, the bound of one HTPU container")
    if block_symbols < 1:
        raise ValueError("block_symbols must be positive")
    symbols, is_odd, last_byte = bytes_to_symbols(data)
    n_pairs = symbols.size
    # The decoder emits packed 16-bit symbol pairs: blocks hold an even
    # symbol count.
    B = block_symbols + (block_symbols & 1)
    nblocks = (n_pairs + B - 1) // B
    if codebook is None:
        codebook = _host_codebook(histogram_host(symbols), max_code_len)

    out = _build_header(2, data, is_odd, last_byte, codebook, B, nblocks)
    out += _codebook_to_header(codebook)
    if nblocks == 0:
        out += (0).to_bytes(4, "little")  # ngroups
    else:
        if codebook.max_len > PACKED_MAX_LEN:
            raise NotImplementedError(
                f"codebooks deeper than {PACKED_MAX_LEN} bits (ROADMAP.md, "
                "Queue 1: v1 / reference-format device paths and wide codes)"
            )
        tables = tables_from_codebook(codebook, device)
        n_lanes = -(-nblocks // GROUP_LANES) * GROUP_LANES
        raw = np.frombuffer(data, np.uint8, count=2 * n_pairs)
        streams = _encode_streams(raw, tables, n_lanes, B, nblocks, device)
        out = _emit_streams(out, streams, nblocks)
    if len(out) >= _HEADER_BYTES + len(data):
        # Incompressible input: stored mode (flags bit2), header + raw bytes.
        header = _build_header(1, data, False, 0, codebook, B, 0)
        header[5] |= 4
        return bytes(header) + data
    return bytes(out)


def _encode_streams(
    raw: np.ndarray,        # (2 * n_pairs,) u8 input bytes (odd tail excluded)
    tables: Tables,
    n_lanes: int,
    B: int,
    n_real: int,            # real block lanes
    device: torch.device,
) -> list[np.ndarray]:
    """Device encode straight to the per-group interleaved streams."""
    n_pairs = raw.size // 2
    padded = np.zeros(n_lanes * B * 2, dtype=np.uint8)
    padded[: raw.size] = raw
    # Little-endian byte pairs ARE the u16 symbols: a reinterpreting view on
    # the device does what bytes_to_symbols_device does.
    symbols = torch.from_numpy(padded).to(device).view(torch.int16).reshape(n_lanes, B)
    codes, lens = gather_codes(symbols, tables.enc_packed, n_pairs)
    pos = torch.arange(n_lanes * B, device=device).reshape(n_lanes, B)
    # Protocol lengths: garbage steps past the data consume min_len zero bits.
    eff = torch.where(pos < n_pairs, lens, tables.min_len).to(torch.int32)
    lane = torch.arange(n_lanes, device=device)
    bits = torch.where(lane < n_real, eff.sum(dim=1), 0)
    gwords = (bits >> 5).reshape(-1, GROUP_LANES).sum(dim=1)
    cap = _bucket_words(max(int(gwords.max()), 128))
    streams, counts = pack_streams(codes, eff, n_real, cap)
    counts = counts.cpu().numpy()
    host = to_numpy_u32(streams[:, : int(counts.max())])
    return [host[g, : counts[g]] for g in range(host.shape[0])]


# --------------------------------------------------------------------------
# decompress
# --------------------------------------------------------------------------

def decompress(blob: bytes, device: torch.device) -> bytes:
    """Original bytes of an HTPU container, payload decoded on ``device``."""
    c = ParsedContainer(blob)
    if c.stored:
        data = bytes(c.payload[: c.original_size])
        if len(data) != c.original_size:
            raise ValueError("truncated stored container")
    else:
        n_pairs = (c.original_size - (1 if c.is_odd else 0)) // 2
        symbols = np.zeros(0, np.uint16)
        if n_pairs:
            if c.version != 2:
                raise NotImplementedError(
                    "HTPU v1 (block slab) containers: ROADMAP.md, Queue 1, "
                    "v1 / reference-format device paths"
                )
            symbols = _decode_v2(c, device)[:n_pairs]
        data = symbols_to_bytes(symbols, c.is_odd, c.last_byte)
    if (zlib.crc32(data) & 0xFFFFFFFF) != c.crc32:
        raise ValueError("CRC mismatch: corrupt container or decode bug")
    return data


def _decode_v2(c: ParsedContainer, device: torch.device) -> np.ndarray:
    """Decoded symbols of a v2 container, block-major, as u16."""
    cb = c.codebook
    if cb.n_unique == 0:
        raise ValueError("corrupt container: symbols but an empty codebook")
    B = c.block_symbols
    if B % 2:
        raise ValueError("corrupt container: odd block_symbols")
    tables = tables_from_codebook(cb, device)
    stacked, _ = il.pad_streams(list(c.streams))
    streams = from_numpy_u32(stacked.reshape(c.ngroups, -1), device)
    n_real = np.clip(c.num_blocks - GROUP_LANES * np.arange(c.ngroups), 0, GROUP_LANES)
    n_real = torch.from_numpy(n_real.astype(np.int32)).to(device)
    translate = cb.n_unique <= TRANSLATE_MAX_ALPHABET
    out = decode_groups(streams, n_real, tables, B, translate)
    if not translate:
        out = gather_u16_pairs(out, tables.sym_order)
    # (g, step pair, lane) -> (g, lane, step pair): block-major u16 pairs.
    words = out.reshape(c.ngroups, B // 2, GROUP_LANES).transpose(1, 2).contiguous()
    return to_numpy_u32(words).reshape(-1).view("<u2")
