"""Plain NumPy reference of the HTPU container, version 2 (interleaved
groups), written from the format's description and independent of the
codec under test.

The format (docs/FORMATS.md, sections 2 and 3, restated here):

* Symbols are the input's little-endian byte pairs; an odd input keeps its
  last byte raw in the header.
* The code is the optimal length-limited prefix code (package-merge, the
  "coin collector" construction) over the symbols present. Leaves are
  ordered by (count, symbol); where a leaf and a package weigh the same,
  the leaf comes first. Codes are canonical: symbols sorted by (length,
  symbol) take consecutive codes, each length starting at
  ``(first[l - 1] + count[l - 1]) << 1``.
* Header, 32 bytes little-endian: magic "HTPU", version 2, flags (bit 0 odd
  input, bit 2 stored), the raw last byte, the longest code length, the
  input size (u64), symbols per block, blocks, distinct symbols, CRC32 of
  the input. Then u32[32] counts of codes per length and the u16 symbols
  in canonical order.
* Blocks of ``block_symbols`` symbols are lanes; 1024 lanes make a group.
  Each lane's codes are written MSB first into 32-bit words. A decoder
  preloads words 0 and 1 of every lane, consumes one code per lane per
  step, and after a step refills one word in every lane left with fewer
  than 33 bits; the refills of a step take consecutive stream slots in lane
  order. So a lane refills after step t exactly when its running bit count
  passes a multiple of 32, and that refill carries word ``bits >> 5`` + 1.
  Steps past the input decode zero bits as the all-zeros code, of the
  shortest length, and count at that length.
* Payload: u32 groups, u32 words per group, then each group's words: the
  real lanes' words 0, their words 1, then the refills in (step, lane)
  order.
* An output not shorter than 32 bytes + the input is replaced by the
  stored form: the header (version 1, flags bit 2, no blocks) and the raw
  input.

``encode`` writes the container; ``decode`` reads one back. ``crc=False``
and ``reorder=False`` (the symbols in the order lanes decode them, step by
step, instead of block by block) each break a guarantee: they make the
controls of the compress and decompress cells.
"""

from __future__ import annotations

import zlib

import numpy as np

MAGIC = 0x48545055
HEADER_BYTES = 32
LENGTH_SLOTS = 32  # the header's counts table: lengths 1..32
LANES = 1024
ALPHABET = 1 << 16


def code_lengths(counts: np.ndarray, limit: int) -> np.ndarray:
    """Optimal code lengths, no longer than ``limit``, of the symbols with
    a non-zero count in the dense ``counts`` table: (65536,) uint8, 0 for
    absent symbols."""
    lengths = np.zeros(ALPHABET, dtype=np.uint8)
    present = np.flatnonzero(counts)
    n = present.size
    if n == 0:
        return lengths
    if n == 1:
        lengths[present] = 1
        return lengths
    if n > (1 << limit):
        raise ValueError(f"{n} symbols do not fit codes of {limit} bits")
    weight = counts[present].astype(np.int64)
    order = np.lexsort((present, weight))
    leaf_sym = present[order]
    leaf_w = weight[order]

    # Lists from the deepest length up: the leaves, then at each length the
    # leaves merged with the pairs of the list below. is_pkg marks pairs.
    lists = []
    prev = leaf_w
    lists.append(np.zeros(n, dtype=bool))
    for _ in range(limit - 1):
        pairs = prev[: prev.size // 2 * 2].reshape(-1, 2).sum(axis=1)
        merged_w = np.concatenate([leaf_w, pairs])
        is_pkg = np.concatenate([np.zeros(n, dtype=bool), np.ones(pairs.size, dtype=bool)])
        order = np.argsort(merged_w, kind="stable")  # leaves before pairs on ties
        prev = merged_w[order]
        lists.append(is_pkg[order])

    # Take the 2n - 2 cheapest items of the top list; a taken leaf adds one
    # to its length, a taken pair takes two items of the list below.
    depth = np.zeros(n, dtype=np.int64)
    take = 2 * n - 2
    for is_pkg in reversed(lists):
        chosen = is_pkg[:take]
        n_pairs = int(chosen.sum())
        depth[: take - n_pairs] += 1
        take = 2 * n_pairs
    lengths[leaf_sym] = depth.astype(np.uint8)
    return lengths


class Canonical:
    """The canonical code of a length table."""

    def __init__(self, lengths: np.ndarray):
        self.lengths = np.asarray(lengths, dtype=np.uint8)
        present = np.flatnonzero(self.lengths)
        lens = self.lengths[present].astype(np.int64)
        order = np.lexsort((present, lens))
        self.symbols = present[order].astype(np.uint16)  # canonical order
        sorted_lens = lens[order]
        self.count = np.bincount(sorted_lens, minlength=LENGTH_SLOTS + 1).astype(np.int64)
        self.first = np.zeros(LENGTH_SLOTS + 2, dtype=np.int64)
        for l in range(1, LENGTH_SLOTS + 1):
            self.first[l + 1] = (self.first[l] + self.count[l]) << 1
        self.shorter = np.concatenate([[0], np.cumsum(self.count)])  # codes shorter than l
        self.codes = np.zeros(ALPHABET, dtype=np.int64)
        rank_in_len = np.arange(present.size) - self.shorter[sorted_lens]
        self.codes[self.symbols] = self.first[sorted_lens] + rank_in_len
        self.max_len = int(sorted_lens.max(initial=0))
        self.min_len = int(sorted_lens.min()) if sorted_lens.size else 0

    def table_bytes(self) -> bytes:
        return self.count[1:].astype("<u4").tobytes() + self.symbols.astype("<u2").tobytes()


def _header(version: int, flags: int, last_byte: int, max_len: int, size: int,
            block_symbols: int, nblocks: int, n_unique: int, crc: int) -> bytes:
    return b"".join([
        MAGIC.to_bytes(4, "little"), bytes([version, flags, last_byte, max_len]),
        size.to_bytes(8, "little"), block_symbols.to_bytes(4, "little"),
        nblocks.to_bytes(4, "little"), n_unique.to_bytes(4, "little"),
        crc.to_bytes(4, "little"),
    ])


def encode(data: bytes, block_symbols: int = 512, max_code_len: int = 18,
           crc: bool = True) -> bytes:
    """The v2 container of ``data``; ``crc=False`` writes 0 in place of the
    CRC32."""
    size = len(data)
    is_odd = size % 2
    last_byte = data[-1] if is_odd else 0
    B = block_symbols + (block_symbols & 1)
    sym = np.frombuffer(data, dtype="<u2", count=size // 2)
    n_sym = sym.size
    nblocks = -(-n_sym // B)
    code = Canonical(code_lengths(np.bincount(sym, minlength=ALPHABET), max_code_len))
    check = zlib.crc32(data) & 0xFFFFFFFF if crc else 0
    head = _header(2, is_odd, last_byte, code.max_len, size, B, nblocks,
                   code.symbols.size, check)
    out = [head, code.table_bytes()]
    ngroups = -(-nblocks // LANES)
    out.append(ngroups.to_bytes(4, "little"))
    if nblocks:
        counts, words = _streams(sym, code, B, nblocks)
        out += [counts.astype("<u4").tobytes(), words.astype("<u4").tobytes()]
    blob = b"".join(out)
    if len(blob) >= HEADER_BYTES + size:
        return _header(1, 4, 0, code.max_len, size, B, 0, code.symbols.size, check) + data
    return blob


def _streams(sym: np.ndarray, code: Canonical, B: int, nblocks: int):
    """(words per group, all groups' words) of the interleaved payload."""
    n_sym = sym.size
    lens = np.full(nblocks * B, code.min_len, dtype=np.int32)  # steps past the input
    vals = np.zeros(nblocks * B, dtype=np.uint64)
    lens[:n_sym] = code.lengths[sym]
    vals[:n_sym] = code.codes.astype(np.uint64)[sym]
    lens = lens.reshape(nblocks, B)
    ends = np.cumsum(lens, axis=1, dtype=np.int32)  # bits after each step
    starts = ends - lens
    lane_words = int(ends[:, -1].max()) // 32 + 2  # words 0 .. R + 1
    # Each code sits in a 64-bit window over words (start >> 5, + 1): the
    # codes starting in a word fill its high half; the last of them may
    # spill into the next word.
    window = (vals.reshape(nblocks, B) << (64 - (starts & 31) - lens).astype(np.uint64)).ravel()
    at = ((np.arange(nblocks, dtype=np.int64) * lane_words)[:, None] + (starts >> 5)).ravel()
    new_word = np.empty(at.size, dtype=bool)
    new_word[0] = True
    np.not_equal(at[1:], at[:-1], out=new_word[1:])
    seg = np.flatnonzero(new_word)
    last = np.append(seg[1:], at.size) - 1
    words = np.zeros(nblocks * lane_words, dtype=np.uint64)
    words[at[seg]] = np.bitwise_or.reduceat(window, seg) >> np.uint64(32)
    words[at[last] + 1] |= window[last] & np.uint64(0xFFFFFFFF)
    words = words.astype(np.uint32).reshape(nblocks, lane_words)

    refilled = ends >> 5  # refills after each step
    fires = np.diff(refilled, axis=1, prepend=0) > 0
    ngroups = -(-nblocks // LANES)
    counts = np.empty(ngroups, dtype=np.int64)
    parts = []
    for g in range(ngroups):
        lanes = slice(g * LANES, min(nblocks, (g + 1) * LANES))
        step, lane = np.nonzero(fires[lanes].T)  # (step, lane) order
        lane_abs = lane + g * LANES
        body = words[lane_abs, refilled[lane_abs, step] + 1]
        part = np.concatenate([words[lanes, 0], words[lanes, 1], body])
        counts[g] = part.size
        parts.append(part)
    return counts, np.concatenate(parts)


class Container:
    """A parsed v2 (or stored) container."""

    def __init__(self, blob: bytes):
        if len(blob) < HEADER_BYTES or int.from_bytes(blob[:4], "little") != MAGIC:
            raise ValueError("not an HTPU container")
        self.version, flags, self.last_byte, self.max_len = blob[4:8]
        self.is_odd = bool(flags & 1)
        self.stored = bool(flags & 4)
        self.size = int.from_bytes(blob[8:16], "little")
        self.B = int.from_bytes(blob[16:20], "little")
        self.nblocks = int.from_bytes(blob[20:24], "little")
        self.n_unique = int.from_bytes(blob[24:28], "little")
        self.crc = int.from_bytes(blob[28:32], "little")
        if self.stored:
            self.raw = blob[HEADER_BYTES:HEADER_BYTES + self.size]
            self.group_words = np.zeros(0, dtype=np.int64)
            return
        if self.version != 2 or flags & 2:
            raise ValueError("the reference reads v2 containers with their codebook")
        off = HEADER_BYTES
        count = np.frombuffer(blob, "<u4", LENGTH_SLOTS, off).astype(np.int64)
        off += 4 * LENGTH_SLOTS
        symbols = np.frombuffer(blob, "<u2", self.n_unique, off)
        off += 2 * self.n_unique
        lengths = np.zeros(ALPHABET, dtype=np.uint8)
        lengths[symbols] = np.repeat(np.arange(1, LENGTH_SLOTS + 1), count)
        self.code = Canonical(lengths)
        ngroups = int.from_bytes(blob[off:off + 4], "little")
        off += 4
        self.group_words = np.frombuffer(blob, "<u4", ngroups, off).astype(np.int64)
        off += 4 * ngroups
        self.words = np.frombuffer(blob, "<u4", int(self.group_words.sum()), off)

    @property
    def stream_words(self) -> int:
        return int(self.group_words.sum())


def decode(blob: bytes, reorder: bool = True, verify: bool = True) -> bytes:
    """The input that a container holds, its CRC checked unless
    ``verify`` is False."""
    c = Container(blob)
    if c.stored:
        data = bytes(c.raw)
    else:
        data = _decode_streams(c, reorder).astype("<u2").tobytes()
        if c.is_odd:
            data += bytes([c.last_byte])
    if verify and zlib.crc32(data) & 0xFFFFFFFF != c.crc:
        raise ValueError("CRC32 mismatch")
    return data


def _decode_streams(c: Container, reorder: bool) -> np.ndarray:
    n_sym = c.size // 2
    if n_sym == 0:
        return np.zeros(0, dtype=np.uint16)
    code = c.code
    # Left-justified exclusive bound of the codes of each length 1..max_len.
    lengths = np.arange(1, c.max_len + 1)
    limit = (code.first[lengths] + code.count[lengths]) << (32 - lengths)
    ngroups = c.group_words.size
    real = np.minimum(LANES, c.nblocks - LANES * np.arange(ngroups))
    group = np.repeat(np.arange(ngroups), real)
    lane = np.arange(c.nblocks) - group * LANES
    base = np.concatenate([[0], np.cumsum(c.group_words)])[:-1]
    words = c.words.astype(np.uint64)
    buf = (words[base[group] + lane] << np.uint64(32)) | words[base[group] + real[group] + lane]
    live = np.full(c.nblocks, 64, dtype=np.int64)
    slot = base + 2 * real  # next refill slot of each group
    first_lane = np.concatenate([[0], np.cumsum(real)])[:-1]
    out = np.empty((c.B, c.nblocks), dtype=np.uint16)
    mask64 = np.uint64(0xFFFFFFFFFFFFFFFF)
    for t in range(c.B):
        peek = (buf >> np.uint64(32)).astype(np.int64)
        length = np.searchsorted(limit, peek, side="right") + 1
        rank = code.shorter[length] + (peek >> (32 - length)) - code.first[length]
        out[t] = code.symbols[rank]
        buf = (buf << length.astype(np.uint64)) & mask64
        live -= length
        refill = live < 33
        order = np.cumsum(refill) - refill  # refilling lanes before this one
        at = slot[group] + order - order[first_lane][group]
        idx = np.flatnonzero(refill)
        buf[idx] |= words[at[idx]] << (32 - live[idx]).astype(np.uint64)
        live[idx] += 32
        slot += np.bincount(group[idx], minlength=ngroups)
    symbols = out.T if reorder else out  # (lane, step): block by block
    return np.ascontiguousarray(symbols).ravel()[:n_sym]
