"""HTPU container: counterpart of huffman_tpu/container/block_format.py,
for version 2 (interleaved groups) and version 1 (per-block slabs).

The host side is the port's own copy of the JAX package's: the header
(``_build_header``, ``_codebook_to_header``, ``_codebook_from_header``),
the payload tails (``_emit_streams``, ``_compress_v1``'s bit table and
big-endian words), the parser (``ParsedContainer``, with ``slab()`` for
v1) and the host codebook (``_host_codebook``). A header may leave the
codebook out (``embed_codebook=False``, flags bit 1); decompress then
takes it as ``codebook=``. The device side is what ran on the TPU, in two
compress routes chosen as the JAX package chooses them on a device:

* the fused route (``_compress_v2_fused``), for v2 inputs of at least
  ``DEVICE_MIN_PAIRS`` symbols with no given codebook and a length limit
  in 16..26: histogram, package-merge codebook, rank gather and lane pack
  all on the device (``ops/fused.py``);
* the host-codebook route otherwise: the codebook is built on the host (or
  given), and the device gathers codes (K3, or the two-table gather of
  ``ops/encode.py`` for codes deeper than 26 bits) and packs lanes (K4),
  into interleaved streams (v2) or per-block slabs (v1, ``pack_blocks``).

Decompress of v2 runs the group decode (K1, translating in-kernel) and
the block-major reorder of its output words; v1 runs ``ops/decode.py``'s
``decode_blocks`` on the slabs. Each thread keeps two host buffers from
call to call, page-locked for a CUDA device: the v2 streams go up from
the upload buffer, which ``ParsedContainer.padded_streams`` fills in one
pass from the payload, and the decoded words of either version come down
into the download buffer, out of which one copy makes the returned bytes.
The decoded words are reordered into a new uint8 tensor on the device,
with an odd input's last byte put in place there (``_output``); on a CUDA
device the CRC32 check reads its original bytes on the card (K11,
``ops/cuda_crc.py``) before they come down, and its 4 bytes come down
with them; on the CPU, and where nothing was decoded, zlib reads the
returned bytes.

``ResidentContainer`` holds a v2 container on a device, parsed and
uploaded once; ``decompress`` of such a handle runs K1 and ``_output``
there and returns the tensor, reading back only the CRC's 4 bytes
(``_decompress_resident``). It uses neither of the thread's buffers.

Each call is a root span of ``utils/profiling.py`` (``compress``,
``decompress``) with its stages as spans inside it, and counts its input
and output bytes; the copies between host and card count their pageable
bytes.

Both routes write containers byte-identical to ``huffman_tpu.compress(data,
backend="numpy")``: the fused route's package-merge lengths equal the
host's, and the streams follow the same decode protocol.
"""

from __future__ import annotations

import functools
import threading
import time
import zlib

import numpy as np
import torch

from ..codebook import Codebook, package_merge_lengths
from ..constants import (
    DEFAULT_BLOCK_SYMBOLS,
    DEFAULT_MAX_CODE_LEN,
    GROUP_LANES,
    MAX_CODE_LEN,
    MAX_SYMBOLS,
    NATIVE_MAGIC,
)
from ..device import resolve_device
from ..ops.cuda_crc import crc32_words
from ..ops.cuda_decode import decode_groups
from ..ops.cuda_encode import bucket_words, encode_streams, pack_blocks
from ..ops.cuda_gather import gather_table_codes
from ..ops.decode import decode_blocks
from ..ops.fused import encode_device_bytes
from ..ops.histogram import bytes_to_symbols_device
from ..ops.tables import PACKED_MAX_LEN, Tables, tables_from_codebook
from ..u32 import from_numpy_u32, to_numpy_u32
from ..utils.profiling import copied, count, span
from . import detect
from . import interleave as il
from .reference_format import bytes_to_symbols, histogram_host, symbols_to_bytes

_HEADER_BYTES = 32
_COUNTS_BYTES = 4 * MAX_CODE_LEN
_PASS_CODEBOOK = "container stores its codebook externally; pass codebook="

# Inputs of at least this many symbols take the fused route, as in the JAX
# package.
DEVICE_MIN_PAIRS = 1 << 21


# --------------------------------------------------------------------------
# header and payload tail (host)
# --------------------------------------------------------------------------

def _codebook_to_header(cb: Codebook) -> bytes:
    with span("header"):
        lens_in_order = cb.lengths[cb.sym_order]
        counts = np.bincount(lens_in_order, minlength=MAX_CODE_LEN + 1)[1:].astype("<u4")
        return counts.tobytes() + cb.sym_order.astype("<u2").tobytes()


def codebook_from_blob(cb_blob: bytes) -> Codebook:
    """Parse a standalone counts++symbols codebook blob (the layout
    _codebook_to_header writes; used by sharded archives)."""
    counts = np.frombuffer(cb_blob[:_COUNTS_BYTES], dtype="<u4")
    n = int(counts.sum())
    syms = np.frombuffer(cb_blob[_COUNTS_BYTES : _COUNTS_BYTES + 2 * n], dtype="<u2")
    if syms.size != n:
        raise ValueError("truncated codebook blob")
    lengths = np.zeros(MAX_SYMBOLS, dtype=np.uint8)
    lengths[syms] = np.repeat(
        np.arange(1, MAX_CODE_LEN + 1, dtype=np.uint8), counts.astype(np.int64)
    )
    return Codebook.from_lengths(lengths)


def _codebook_from_header(blob: bytes, n_unique: int) -> tuple[Codebook, int]:
    counts = np.frombuffer(blob[_HEADER_BYTES : _HEADER_BYTES + _COUNTS_BYTES], dtype="<u4")
    off = _HEADER_BYTES + _COUNTS_BYTES
    syms = np.frombuffer(blob[off : off + 2 * n_unique], dtype="<u2")
    off += 2 * n_unique
    if int(counts.sum()) != n_unique:
        raise ValueError("corrupt codebook: counts do not sum to n_unique")
    lengths = np.zeros(MAX_SYMBOLS, dtype=np.uint8)
    lengths[syms] = np.repeat(
        np.arange(1, MAX_CODE_LEN + 1, dtype=np.uint8), counts.astype(np.int64)
    )
    return Codebook.from_lengths(lengths), off


def _build_header(
    version, data, is_odd, last_byte, cb, B, nblocks, embed_codebook=True
) -> bytearray:
    with span("header"):
        header = bytearray(_HEADER_BYTES)
        header[0:4] = int(NATIVE_MAGIC).to_bytes(4, "little")
        header[4] = version
        # flags: bit0 odd input, bit1 codebook stored outside the container
        header[5] = (1 if is_odd else 0) | (0 if embed_codebook else 2)
        header[6] = last_byte
        header[7] = cb.max_len
        header[8:16] = len(data).to_bytes(8, "little")
        header[16:20] = B.to_bytes(4, "little")
        header[20:24] = nblocks.to_bytes(4, "little")
        header[24:28] = cb.n_unique.to_bytes(4, "little")
        with span("crc32"):
            crc = zlib.crc32(data) & 0xFFFFFFFF
        header[28:32] = crc.to_bytes(4, "little")
        return header


def _emit_streams(out: bytearray, streams, nblocks: int) -> bytes:
    """Append the v2 payload tail (ngroups, per-group word counts, stream
    words), stripping pad-lane preload zeros: each stream's first
    2*GROUP_LANES words are w0[lane 0..1023], w1[lane 0..1023]; only the
    first n_real of each half carry data. The parser reinserts the
    zeros."""
    with span("emit"):
        stripped = []
        for g, s in enumerate(streams):
            n_real = max(0, min(GROUP_LANES, nblocks - g * GROUP_LANES))
            stripped.append(
                np.concatenate(
                    [s[:n_real], s[GROUP_LANES : GROUP_LANES + n_real], s[2 * GROUP_LANES :]]
                )
            )
        out += len(stripped).to_bytes(4, "little")
        out += np.array([s.size for s in stripped], dtype="<u4").tobytes()
        for s in stripped:
            out += s.astype("<u4").tobytes()
        return bytes(out)


def _host_codebook(freqs: np.ndarray, max_code_len: int | None) -> Codebook:
    """Codebook from host frequencies: optimal length-limited package-merge
    at ``max_code_len`` (the fused route's construction, so both routes
    agree byte for byte), or the unlimited two-queue code for None."""
    if max_code_len is not None:
        return Codebook.from_lengths(package_merge_lengths(freqs, max_code_len))
    return Codebook.from_frequencies(freqs)


# --------------------------------------------------------------------------
# compress
# --------------------------------------------------------------------------

def compress(
    data: bytes,
    device: torch.device,
    block_symbols: int = DEFAULT_BLOCK_SYMBOLS,
    max_code_len: int | None = DEFAULT_MAX_CODE_LEN,
    codebook: Codebook | None = None,
    mode: str = "interleaved",
    embed_codebook: bool = True,
) -> bytes:
    """HTPU container of ``data`` (v2 for ``mode="interleaved"``, v1 for
    ``"blocks"``), payload encoded on ``device``, by the route the JAX
    package's ``compress`` takes on a device. ``codebook`` is the port's
    ``Codebook`` (a JAX one carries over as
    ``Codebook.from_lengths(jax_codebook.lengths)``); giving one selects
    the host-codebook route. ``embed_codebook=False`` (which needs a given
    codebook) leaves it out of the header."""
    data = bytes(data)
    if len(data) > (1 << 32):
        raise ValueError("input exceeds 4 GiB, the bound of one HTPU container")
    if block_symbols < 1:
        raise ValueError("block_symbols must be positive")
    if mode not in ("interleaved", "blocks"):
        raise ValueError(f"unknown mode {mode!r}")
    if codebook is None and not embed_codebook:
        raise ValueError("embed_codebook=False requires an explicit codebook")
    with span("compress"):
        count("bytes_in", len(data))
        n_pairs = len(data) // 2
        is_odd = len(data) % 2 == 1
        last_byte = data[-1] if is_odd else 0
        # The decoder emits packed 16-bit symbol pairs: blocks hold an even
        # symbol count.
        B = block_symbols + (block_symbols & 1)
        nblocks = (n_pairs + B - 1) // B
        if (
            codebook is None
            and mode == "interleaved"
            and nblocks > 0
            and max_code_len is not None
            and 16 <= max_code_len <= PACKED_MAX_LEN  # >= 16: any alphabet fits
            and DEVICE_MIN_PAIRS <= n_pairs < (1 << 30)
        ):
            out, codebook = _compress_v2_fused(
                data, n_pairs, is_odd, last_byte, B, nblocks, max_code_len, device
            )
        else:
            out, codebook = _compress_host_codebook(
                data, is_odd, last_byte, codebook, B, nblocks, max_code_len, device,
                mode, embed_codebook,
            )
        if len(out) >= _HEADER_BYTES + len(data):
            # Incompressible input: stored mode (flags bit2), header + raw bytes.
            header = _build_header(1, data, False, 0, codebook, B, 0)
            header[5] |= 4
            out = bytes(header) + data
        count("bytes_out", len(out))
        return out


def _compress_host_codebook(data, is_odd, last_byte, codebook, B, nblocks,
                            max_code_len, device, mode, embed_codebook):
    """The container with a host-built (or given) codebook; the payload is
    encoded on ``device``. Returns (container bytes, codebook)."""
    if codebook is None:
        with span("lengths"):
            symbols, _, _ = bytes_to_symbols(data)
            codebook = _host_codebook(histogram_host(symbols), max_code_len)
    version = 2 if mode == "interleaved" else 1
    out = _build_header(
        version, data, is_odd, last_byte, codebook, B, nblocks, embed_codebook
    )
    if embed_codebook:
        out += _codebook_to_header(codebook)
    if nblocks == 0:
        if version == 2:
            out += (0).to_bytes(4, "little")  # ngroups
        return bytes(out), codebook
    with span("tables"):
        tables = tables_from_codebook(codebook, device)
    n_pairs = len(data) // 2
    raw = _upload_bytes(data, n_pairs, nblocks, B, device)
    with span("encode"):
        sym = bytes_to_symbols_device(raw)
        codes, lens = gather_table_codes(sym.reshape(-1, B), tables, n_pairs)
        if version == 2:
            streams, counts = encode_streams(codes, lens, n_pairs, tables.min_len, nblocks)
    if version == 1:
        return _emit_slabs(out, codes[:nblocks], lens[:nblocks]), codebook
    return _emit_streams(out, _streams_to_host(streams, counts), nblocks), codebook


def _emit_slabs(out: bytearray, codes: torch.Tensor, lens: torch.Tensor) -> bytes:
    """Append the v1 payload tail: the per-block bit counts, then each
    block's words (its bits rounded up to whole words) as big-endian u32.
    The slab width is the bucketed word count of the largest block, read
    to the host with the bit counts; only the blocks' own words cross the
    link."""
    with span("download"):
        block_bits = lens.sum(dim=1, dtype=torch.int64)
        bits_host = copied(block_bits, block_bits.cpu()).numpy()
    W = bucket_words(int((bits_host.max(initial=1) + 31) // 32))
    with span("encode"):
        slab = pack_blocks(codes, lens, W)
        n_words = (block_bits + 31) // 32
        keep = torch.arange(W, device=slab.device)[None, :] < n_words[:, None]
    with span("download"):
        words = to_numpy_u32(slab[keep])
    with span("emit"):
        out += bits_host.astype("<u4").tobytes()
        out += words.astype(">u4").tobytes()
        return bytes(out)


def _compress_v2_fused(data, n_pairs, is_odd, last_byte, B, nblocks,
                       max_code_len, device):
    """The container by the fused device encoder (``ops/fused.py``): the
    host receives the lengths (for the codebook header) and the trimmed
    streams. Returns (container bytes, codebook)."""
    raw = _upload_bytes(data, n_pairs, nblocks, B, device)
    with span("encode"):
        r = encode_device_bytes(raw, n_pairs, B, max_code_len)
    with span("lengths"):
        lengths = r["lengths"]
        cb = Codebook.from_lengths(copied(lengths, lengths.cpu()).numpy().astype(np.uint8))
    out = _build_header(2, data, is_odd, last_byte, cb, B, nblocks)
    out += _codebook_to_header(cb)
    return _emit_streams(out, _streams_to_host(r["streams"], r["counts"]), nblocks), cb


def _upload_bytes(data: bytes, n_pairs: int, nblocks: int, B: int,
                  device: torch.device) -> torch.Tensor:
    """The input's byte pairs (the odd tail excluded), zero-padded to
    whole groups of blocks, as a (n_lanes * B * 2,) uint8 tensor on
    ``device``."""
    with span("upload"):
        n_lanes = -(-nblocks // GROUP_LANES) * GROUP_LANES
        padded = np.zeros(n_lanes * B * 2, dtype=np.uint8)
        padded[: 2 * n_pairs] = np.frombuffer(data, np.uint8, count=2 * n_pairs)
        host = torch.from_numpy(padded)
        return copied(host, host.to(device))


def _streams_to_host(streams: torch.Tensor, counts: torch.Tensor) -> list[np.ndarray]:
    """Per-group u32 streams on the host, each trimmed to its word count;
    only the longest group's words cross the link."""
    with span("download"):
        counts = copied(counts, counts.cpu()).numpy()
        host = to_numpy_u32(streams[:, : int(counts.max())])
        return [host[g, : counts[g]] for g in range(host.shape[0])]


# --------------------------------------------------------------------------
# parse + decompress
# --------------------------------------------------------------------------

class ParsedContainer:
    """Parsed HTPU header and payload (host side): v2 payloads as a view of
    the blob's words with each group's start (``streams`` splits them into
    per-group streams on first use, ``padded_streams`` writes the decoder's
    padded rows), v1 payloads as the per-block bit table and the packed
    words (``slab()`` re-slabs them), stored payloads as they are.
    ``codebook`` is used when the header stores none (flags bit 1)."""

    def __init__(self, blob: bytes, codebook: Codebook | None = None):
        if len(blob) < _HEADER_BYTES or int.from_bytes(blob[0:4], "little") != NATIVE_MAGIC:
            raise ValueError("not an HTPU container")
        self.version = blob[4]
        if self.version not in (1, 2):
            raise ValueError(f"unsupported container version {blob[4]}")
        self.is_odd = bool(blob[5] & 1)
        self.external_codebook = bool(blob[5] & 2)
        self.stored = bool(blob[5] & 4)
        self.last_byte = blob[6]
        self.max_len = blob[7]
        self.original_size = int.from_bytes(blob[8:16], "little")
        self.block_symbols = int.from_bytes(blob[16:20], "little")
        self.num_blocks = int.from_bytes(blob[20:24], "little")
        self.n_unique = int.from_bytes(blob[24:28], "little")
        self.crc32 = int.from_bytes(blob[28:32], "little")
        if self.stored:
            self.codebook = None
            self.payload = blob[_HEADER_BYTES:]
            return
        # Structural sanity before any size-driven allocation (a corrupt
        # count field must raise, not MemoryError).
        if self.block_symbols == 0 or self.block_symbols > (1 << 24):
            raise ValueError("corrupt container: bad block_symbols")
        n_pairs = (self.original_size - (1 if self.is_odd else 0)) // 2
        expect_blocks = (n_pairs + self.block_symbols - 1) // self.block_symbols
        if self.num_blocks != expect_blocks:
            raise ValueError("corrupt container: block count mismatch")
        if self.n_unique > MAX_SYMBOLS:
            raise ValueError("corrupt container: bad unique count")
        if self.external_codebook:
            if codebook is None:
                raise ValueError(_PASS_CODEBOOK)
            self.codebook, off = codebook, _HEADER_BYTES
        else:
            self.codebook, off = _codebook_from_header(blob, self.n_unique)
        if self.version == 1:
            self.block_bits = np.frombuffer(
                blob[off : off + 4 * self.num_blocks][: (len(blob) - off) & ~3],
                dtype="<u4",
            ).astype(np.int64)
            off += 4 * self.num_blocks
            if self.block_bits.size != self.num_blocks:
                raise ValueError("truncated container: block bit table")
            if self.num_blocks and self.block_bits.max() > 32 * self.block_symbols:
                raise ValueError("corrupt container: block bits exceed block size")
            self.payload = blob[off:]
            return
        self.ngroups = int.from_bytes(blob[off : off + 4], "little")
        off += 4
        if self.ngroups != (self.num_blocks + GROUP_LANES - 1) // GROUP_LANES:
            raise ValueError("corrupt container: group count mismatch")
        self.group_words = np.frombuffer(
            blob[off : off + 4 * self.ngroups][: (len(blob) - off) & ~3], dtype="<u4"
        ).astype(np.int64)
        off += 4 * self.ngroups
        if self.group_words.size != self.ngroups:
            raise ValueError("truncated container: group table")
        if self.ngroups and self.group_words.max() > (len(blob) + 3) // 4:
            raise ValueError("corrupt container: group words exceed payload")
        total = int(self.group_words.sum())
        if max(len(blob) - off, 0) < 4 * total:
            raise ValueError("truncated container payload")
        self.n_real = np.clip(
            self.num_blocks - GROUP_LANES * np.arange(self.ngroups), 0, GROUP_LANES
        )
        # Each real lane's two preload words lead its group's words.
        if (self.group_words < 2 * self.n_real).any():
            raise ValueError("corrupt container: group words below its preload words")
        # The payload stays in the blob: ``streams`` and ``padded_streams``
        # read each group's words from this view.
        self.words = np.frombuffer(memoryview(blob)[off : off + 4 * total], dtype="<u4")
        self.group_starts = np.concatenate(([0], np.cumsum(self.group_words)))

    @functools.cached_property
    def streams(self) -> list[np.ndarray]:
        """v2: each group's stream with the pad lanes' preload zeros, which
        the writer strips, put back: (2 * GROUP_LANES + the group's words
        after its preloads,) u32 each."""
        parts = np.split(self.words, self.group_starts[1:-1])
        out = []
        for g, s in enumerate(parts):
            n_real = max(0, min(GROUP_LANES, self.num_blocks - g * GROUP_LANES))
            w0 = np.zeros(GROUP_LANES, dtype=np.uint32)
            w1 = np.zeros(GROUP_LANES, dtype=np.uint32)
            w0[:n_real] = s[:n_real]
            w1[:n_real] = s[n_real : 2 * n_real]
            out.append(np.concatenate([w0, w1, s[2 * n_real :].astype(np.uint32)]))
        return out

    @property
    def row_words(self) -> int:
        """v2: the words of each row of ``padded_streams``, as
        ``il.pad_streams(self.streams)`` pads them."""
        lengths = self.group_words + 2 * (GROUP_LANES - self.n_real)
        return 128 * il.padded_rows(int(lengths.max(initial=0)))

    def padded_streams(self, out: np.ndarray | None = None) -> np.ndarray:
        """v2: ``il.pad_streams(self.streams)[0]`` as (ngroups, row_words)
        u32, written in one pass from the payload words into ``out`` (a
        contiguous u32 array of that many words, whatever it holds; a new
        one by default). Per group: the real lanes' first preload words
        to lanes [0, n_real), their second ones to [L, L + n_real), the
        rest from word 2L on, zeros elsewhere (L = GROUP_LANES)."""
        L, w = GROUP_LANES, self.row_words
        if out is None:
            out = np.empty((self.ngroups, w), dtype=np.uint32)
        rows = out.reshape(self.ngroups, w)
        starts = self.group_starts.tolist()
        for g, n in enumerate(self.n_real.tolist()):
            s, row = self.words[starts[g] : starts[g + 1]], rows[g]
            end = 2 * L + s.size - 2 * n
            row[:n] = s[:n]
            row[n:L] = 0
            row[L : L + n] = s[n : 2 * n]
            row[L + n : 2 * L] = 0
            row[2 * L : end] = s[2 * n :]
            row[end:] = 0
        return rows

    def slab(self) -> np.ndarray:
        """v1: the packed payload re-slabbed into (num_blocks, W) u32 rows,
        W the bucketed word count of the largest block."""
        word_counts = (self.block_bits + 31) // 32
        W = bucket_words(int(word_counts.max(initial=1)))
        words = np.frombuffer(
            self.payload[: int(word_counts.sum()) * 4], dtype=">u4"
        ).astype(np.uint32)
        starts = np.cumsum(word_counts) - word_counts
        rows = np.repeat(np.arange(self.num_blocks, dtype=np.int64), word_counts)
        within = np.arange(words.size, dtype=np.int64) - np.repeat(starts, word_counts)
        slab = np.zeros((self.num_blocks, W), dtype=np.uint32)
        slab.reshape(-1)[rows * W + within] = words
        return slab


class ResidentContainer:
    """An HTPU container held on a device and decoded there whole by each
    ``decompress(handle)``, with no copy of its data between host and
    card: the form for data kept on the card and decoded where it is used.

    Loading (a root span ``load``) parses ``blob`` once and keeps on
    ``device`` what every decode needs. For v2: K1's padded stream rows,
    filled by ``ParsedContainer.padded_streams`` into a fresh host array
    that is freed when the load returns (not the thread's reused upload
    buffer), each group's real lanes and K1's decode tables. For a stored
    container or one that holds no byte pair: the raw bytes. The header's
    scalars stay on the host. v1, HTPS and HTPX containers, and one that
    stores no codebook, raise ``ValueError``: ``decompress(bytes)`` reads
    them.

    Nothing writes the handle's tensors after the load, so any thread may
    decode it, and each decode returns a tensor of its own. They hold
    ``nbytes`` of the device's memory until the handle is dropped. The
    root counts ``resident_bytes`` (``nbytes``) and ``original_bytes``."""

    def __init__(self, blob: bytes, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        kind = detect(blob)
        if kind in ("htps", "htpx"):
            raise ValueError(
                f"a ResidentContainer holds one HTPU container, not an {kind.upper()} "
                "one: decode it with decompress(bytes)")
        with span("load"):
            with span("parse"):
                try:
                    c = ParsedContainer(blob)
                except ValueError as e:
                    if str(e) != _PASS_CODEBOOK:
                        raise
                    raise ValueError(f"{_PASS_CODEBOOK} to decompress(bytes)") from None
            n_pairs = (c.original_size - (1 if c.is_odd else 0)) // 2
            if not c.stored and c.version != 2:
                raise ValueError(
                    f"a ResidentContainer holds v2 containers, not v{c.version}: decode "
                    "it with decompress(bytes)")
            self.device = dev
            self.container_bytes = len(blob)
            self.original_size = c.original_size
            self.crc32 = c.crc32
            self.is_odd, self.last_byte = c.is_odd, c.last_byte
            self.block_symbols, self.ngroups = c.block_symbols, 0
            self.streams = self.n_real = self.tables = self.raw = None
            if c.stored or n_pairs <= 0:
                if c.stored:
                    raw = bytes(c.payload[: c.original_size])
                    if len(raw) != c.original_size:
                        raise ValueError("truncated stored container")
                else:  # at most the odd byte, as decompress(bytes) returns it
                    raw = bytes([c.last_byte]) if c.is_odd else b""
                    self.original_size = len(raw)
                with span("upload"):
                    host = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw else \
                        torch.empty(0, dtype=torch.uint8)
                    self.raw = copied(host, host.to(dev))
                held = [self.raw]
            else:
                self.ngroups = c.ngroups
                # K1 reads the decode tables alone.
                tables = _v2_tables(c, dev)
                self.tables = tables._replace(enc_packed=None, enc_codes=None, enc_lens=None)
                with span("pad"):
                    host = torch.from_numpy(c.padded_streams().view(np.int32))
                with span("upload"):
                    self.streams = copied(host, host.to(dev))
                    n_real = torch.from_numpy(c.n_real.astype(np.int32))
                    self.n_real = copied(n_real, n_real.to(dev))
                held = [self.streams, self.n_real, self.tables.lj_limit, self.tables.base,
                        self.tables.sym_order]
            self.nbytes = sum(t.nbytes for t in held)
            count("resident_bytes", self.nbytes)
            count("original_bytes", self.original_size)


def decompress(
    blob: bytes | ResidentContainer,
    device: torch.device,
    verify_crc: bool = True,
    codebook: Codebook | None = None,
) -> bytes | torch.Tensor:
    """Original bytes of an HTPU container, payload decoded on ``device``.
    ``codebook`` is needed, and used, only when the header stores none.
    A ``ResidentContainer`` in place of the bytes decodes on the device
    that holds it (``device`` and ``codebook`` are not read) into a new
    uint8 tensor there (``_decompress_resident``). The root counts
    ``crc_device`` or ``crc_host`` for a verified call, by where the CRC32
    was taken."""
    with span("decompress"):
        if isinstance(blob, ResidentContainer):
            return _decompress_resident(blob, verify_crc)
        count("bytes_in", len(blob))
        with span("parse"):
            c = ParsedContainer(blob, codebook=codebook)
        crc = None  # the card's CRC32 of the original bytes, where it took one
        if c.stored:
            data = bytes(c.payload[: c.original_size])
            if len(data) != c.original_size:
                raise ValueError("truncated stored container")
        else:
            n_pairs = (c.original_size - (1 if c.is_odd else 0)) // 2
            if not n_pairs:  # at most the odd byte
                data = symbols_to_bytes(np.zeros(0, np.uint16), c.is_odd, c.last_byte)
            else:
                decode = _decode_v1 if c.version == 1 else _decode_v2
                out, crc = decode(c, device, verify_crc)
                with span("bytes"):
                    # Past the original bytes lie the pad blocks' symbols, never returned.
                    data = out[: c.original_size].tobytes()
        if verify_crc:
            with span("crc32"):
                if crc is None:
                    crc = zlib.crc32(data) & 0xFFFFFFFF
                    count("crc_host", 1)
                else:
                    crc = int(crc) & 0xFFFFFFFF  # read before the thread's next decode
                    count("crc_device", 1)
            if crc != c.crc32:
                raise ValueError("CRC mismatch: corrupt container or decode bug")
        count("bytes_out", len(data))
        return data


def _decode_v1(c: ParsedContainer, device: torch.device, verify_crc: bool):
    """A v1 container's original bytes and the card's CRC32 of them, as
    ``_download`` returns them."""
    if c.codebook.n_unique == 0:
        raise ValueError("corrupt container: symbols but an empty codebook")
    B = c.block_symbols
    if B % 2:
        raise ValueError("corrupt container: odd block_symbols")
    with span("tables"):
        tables = tables_from_codebook(c.codebook, device)
    with span("pad"):
        slab = c.slab()
    with span("upload"):
        slab = from_numpy_u32(slab, device)
    with span("decode"):
        out = decode_blocks(
            slab, tables.lj_limit, tables.base, tables.sym_order, B, tables.max_len
        )
    pairs = out.reshape(-1, 2)
    return _download(*_output(c, pairs[:, 0] | (pairs[:, 1] << 16), verify_crc))


def _decode_v2(c: ParsedContainer, device: torch.device, verify_crc: bool):
    """A v2 container's original bytes and the card's CRC32 of them, as
    ``_download`` returns them."""
    streams, n_real, tables, _ = v2_device_inputs(c, device)
    return _download(*_decode_k1(c, streams, n_real, tables, verify_crc))


def _decode_k1(c, streams: torch.Tensor, n_real: torch.Tensor, tables: Tables,
               verify_crc: bool):
    """K1 over a v2 container's padded rows on their device, then
    ``_output`` of its words; ``c`` is the ``ParsedContainer`` or the
    ``ResidentContainer`` they came from."""
    B = c.block_symbols
    with span("decode"):
        out = decode_groups(streams, n_real, tables, B, True)
    # (g, step pair, lane) -> (g, lane, step pair): block-major u16 pairs.
    return _output(c, out.view(c.ngroups, B // 2, GROUP_LANES).transpose(1, 2), verify_crc)


def _output(c, words: torch.Tensor, verify_crc: bool):
    """The decoded u16 pairs ``words`` (int32, block-major in their index
    order: a strided view does, the copy reorders it) copied into a new
    uint8 tensor on their device, with ``c``'s odd last byte put in place
    after the pairs (``postpack``). Returns its first max(``words``' bytes,
    ``c.original_size``) bytes, of which the first ``original_size`` are
    the original bytes and the rest the pad blocks' symbols; and, for a
    CUDA tensor and ``verify_crc``, K11's CRC32 of the original bytes as a
    one-element tensor there (``crc32``), else None. The tensor's storage
    is rounded up to whole words, which K11 reads."""
    n, m = c.original_size, 4 * words.numel()
    end = max(m, n)
    with span("postpack"):
        buf = torch.empty(-(-end // 4) * 4, dtype=torch.uint8, device=words.device)
        buf[:m].view(torch.int32).view(words.shape).copy_(words)
        if c.is_odd:
            buf[n - 1 : n].fill_(c.last_byte)
    crc = None
    if verify_crc and buf.is_cuda:
        with span("crc32"):
            crc = crc32_words(buf.view(torch.int32), n)
    return buf[:end], crc


def _download(data: torch.Tensor, crc: torch.Tensor | None):
    """The uint8 ``data`` copied, in one blocking copy, to the start of
    the calling thread's download buffer (page-locked for a CUDA tensor,
    so the card writes it directly), returned as a u8 view there; and the
    card's ``crc`` (``_output``), brought down behind it in the same buffer
    by the same copy's wait, as a one-element view there (else None). Both
    views stay valid until the thread's next decode."""
    n = data.numel()
    if crc is None:
        buf = _host_buffer("download", n, data.is_cuda)
        copied(data, buf[:n].copy_(data))
        return buf[:n].numpy(), None
    at = -(-n // 4) * 4
    buf = _host_buffer("download", at + 4, True)
    slot = buf[at : at + 4].view(torch.int32)
    slot.copy_(crc, non_blocking=True)  # the blocking copy below waits for it
    copied(data, buf[:n].copy_(data))
    return buf[:n].numpy(), slot


def _decompress_resident(h: ResidentContainer, verify_crc: bool) -> torch.Tensor:
    """The original bytes of a held container as a new uint8 tensor on its
    device: for v2, ``_decode_k1`` over the held rows; for the raw bytes, a
    copy. On a CUDA device a verified call reads the 4 bytes of K11's
    CRC32 (``wait``): the call's one blocking read, and nothing else
    crosses between host and card. On the CPU zlib takes it. The tensor's
    storage runs on past the original bytes, to whole words, and for v2
    over the pad blocks' symbols. Counts the call's host time less its
    wait as ``host_enqueue_ns``: the host's cost of issuing it."""
    t0 = time.perf_counter_ns()
    count("resident_calls", 1)
    count("bytes_in", h.container_bytes)
    n = h.original_size
    if h.raw is not None:
        with span("postpack"):
            buf = torch.empty(-(-n // 4) * 4 or 4, dtype=torch.uint8, device=h.device)
            buf[:n].copy_(h.raw)
        crc = None
        if verify_crc and buf.is_cuda:
            with span("crc32"):
                crc = crc32_words(buf.view(torch.int32), n)
    else:
        buf, crc = _decode_k1(h, h.streams, h.n_real, h.tables, verify_crc)
    data, waited = buf[:n], 0
    if verify_crc:
        with span("crc32"):
            if crc is not None:
                slot = _host_buffer("crc", 4, True).view(torch.int32)
                with span("wait"):
                    w0 = time.perf_counter_ns()
                    copied(crc, slot.copy_(crc))
                    waited = time.perf_counter_ns() - w0
                crc = int(slot[0]) & 0xFFFFFFFF
                count("crc_device", 1)
            else:
                crc = zlib.crc32(data.numpy()) & 0xFFFFFFFF
                count("crc_host", 1)
        if crc != h.crc32:
            raise ValueError("CRC mismatch: corrupt container or decode bug")
    count("bytes_out", n)
    count("host_enqueue_ns", time.perf_counter_ns() - t0 - waited)
    return data


def v2_device_inputs(c: ParsedContainer, device: torch.device):
    """What the v2 decode takes on ``device``: (streams (ngroups, W)
    int32, n_real (ngroups,) int32, tables, block_symbols). The decode
    translates in K1 at every alphabet (``TRANSLATE_MAX_ALPHABET`` is
    the whole 16-bit alphabet), so it needs no K2 pass."""
    tables = _v2_tables(c, device)
    with span("pad"):
        shape = (c.ngroups, c.row_words)
        pinned = torch.device(device).type == "cuda"
        host = _host_buffer("upload", 4 * shape[0] * shape[1], pinned).view(torch.int32)
        c.padded_streams(host.numpy().view(np.uint32))
    with span("upload"):
        host = host.view(shape)
        # A copy even on the CPU, where ``to`` would hand back the buffer
        # that the thread's next call overwrites.
        streams = copied(host, host.to(device, copy=True))
        n_real = torch.from_numpy(c.n_real.astype(np.int32))
        n_real = copied(n_real, n_real.to(device))
    return streams, n_real, tables, c.block_symbols


def _v2_tables(c: ParsedContainer, device: torch.device) -> Tables:
    """The v2 decode's tables on ``device``, once the codebook and the
    block size pass the checks every v2 decode makes."""
    if c.codebook.n_unique == 0:
        raise ValueError("corrupt container: symbols but an empty codebook")
    if c.block_symbols % 2:
        raise ValueError("corrupt container: odd block_symbols")
    with span("tables"):
        return tables_from_codebook(c.codebook, device)


class _HostBuffers(threading.local):
    """The calling thread's host buffers, by purpose (``upload``,
    ``download``) and by whether they are pinned: HTPS decodes in a pool
    of threads at once. Each purpose has a buffer of its own, so that a
    download never writes over streams whose upload may still be reading
    them."""

    def __init__(self):
        self.by_key: dict[tuple[str, bool], torch.Tensor] = {}


_host_buffers = _HostBuffers()


def _host_buffer(purpose: str, n_bytes: int, pinned: bool) -> torch.Tensor:
    """The first ``n_bytes`` (uint8) of the calling thread's buffer for
    ``purpose``, page-locked where ``pinned`` (for a CUDA device, which then
    copies to or from it directly), allocated anew only where the thread
    has none yet or a shorter one. Counts ``<purpose>_buffer_hits`` when it
    serves the buffer as it stood, ``<purpose>_buffer_misses`` when it
    allocates."""
    buffers, key = _host_buffers.by_key, (purpose, pinned)
    buf = buffers.get(key)
    if buf is not None and buf.numel() >= n_bytes:
        count(f"{purpose}_buffer_hits", 1)
    else:
        buffers.pop(key, None)  # free the short one first
        buf = buffers[key] = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=pinned)
        count(f"{purpose}_buffer_misses", 1)
    return buf[:n_bytes]
