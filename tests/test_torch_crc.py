"""The CRC32 of decoded words (K11, ops/cuda_crc.py) on the CPU: the plain
PyTorch version and the GF(2) arithmetic both it and the kernel rest on
against zlib; a numpy mirror of csrc/crc32.cu's decomposition (lanes
folding interleaved vectors through premultiplied tables, tiles aligned to
the body's end, the combine's 4-bit tables, the unaligned head and the
tail) against zlib; and decompress's CRC check on the CPU, which stays
zlib's over the returned bytes."""

from __future__ import annotations

import functools
import operator
import zlib

import numpy as np
import pytest
import torch

import huffman_tpu_torch
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.ops import cuda_crc
from huffman_tpu_torch.utils import profiling

CHUNK = cuda_crc.PLAIN_CHUNK_BYTES
TILE = cuda_crc.TILE_BYTES


def _words(data: bytes, offset: int = 0) -> torch.Tensor:
    """An int32 tensor whose bytes from ``offset`` on are ``data``,
    zero-padded to whole words; ``offset`` a multiple of 4."""
    raw = np.zeros(offset + len(data) + (-len(data)) % 4, np.uint8)
    raw[offset : offset + len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(raw.view(np.int32).copy())[offset // 4 :]


def _crc(t: torch.Tensor) -> int:
    return int(t.reshape(-1)[0]) & 0xFFFFFFFF


@pytest.mark.parametrize("n", [2, 4, 6, CHUNK - 2, CHUNK, CHUNK + 2, 7 * CHUNK + 34])
def test_plain_crc_matches_zlib(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    words = _words(data + b"\xa5" * 6)  # bytes past n must not count
    got = cuda_crc.crc32_words_plain(words, n)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert _crc(got) == zlib.crc32(data)
    assert _crc(cuda_crc.crc32_words(words, n)) == zlib.crc32(data)  # the CPU route


def test_plain_crc_of_no_bytes_and_of_zeros():
    assert _crc(cuda_crc.crc32_words_plain(torch.zeros(0, dtype=torch.int32), 0)) == 0
    zeros = torch.zeros(3 * CHUNK // 4, dtype=torch.int32)
    assert _crc(cuda_crc.crc32_words_plain(zeros, 3 * CHUNK - 2)) == zlib.crc32(bytes(3 * CHUNK - 2))


def test_plain_crc_of_decoded_v2_words_leaves_the_pad_tail_out(monkeypatch):
    """The decoded output the v2 decode hands the download, in a CPU
    decompress: its first original_size bytes, the odd last byte in place
    after the pairs, give the header's CRC32; the pad blocks' symbols after
    them do not count."""
    rng = np.random.default_rng(8)
    data = (rng.zipf(1.3, 9_000) % 700).astype("<u2").tobytes() + b"\x11"
    blob = huffman_tpu_torch.compress(data, "cpu", block_symbols=64)
    seen = []
    download = bf._download

    def recording(out, crc):
        seen.append((out.clone(), crc))
        return download(out, crc)

    monkeypatch.setattr(bf, "_download", recording)
    assert huffman_tpu_torch.decompress(blob, "cpu") == data
    (out, crc), = seen
    n = len(data)
    assert crc is None and out.numel() > n  # pad symbols follow the original bytes
    words = torch.zeros(-(-out.numel() // 4) * 4, dtype=torch.uint8)
    words[: out.numel()] = out
    crc = _crc(cuda_crc.crc32_words_plain(words.view(torch.int32), n))
    assert crc == bf.ParsedContainer(blob).crc32 == zlib.crc32(data)
    assert _crc(cuda_crc.crc32_words_plain(words.view(torch.int32), n - 1)) == zlib.crc32(data[:-1])


@pytest.mark.parametrize("seed", range(4))
def test_combine_on_random_splits(seed):
    """zlib's CRC32 of A || B from the two halves' CRCs (zlib's
    crc32_combine) and from their raw CRCs, A's moved past B by
    ``multmodp`` with ``x8nmodp(|B|)``."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(1, 5000)), dtype=np.uint8).tobytes()
    for cut in sorted(set(rng.integers(0, len(data) + 1, 6).tolist()) | {0, len(data)}):
        a, b = data[:cut], data[cut:]
        assert cuda_crc.multmodp(cuda_crc.x8nmodp(len(b)), zlib.crc32(a)) ^ zlib.crc32(b) \
            == zlib.crc32(data)
        raw_a = zlib.crc32(a) ^ 0xFFFFFFFF ^ cuda_crc.multmodp(0xFFFFFFFF, cuda_crc.x8nmodp(len(a)))
        raw_b = zlib.crc32(b) ^ 0xFFFFFFFF ^ cuda_crc.multmodp(0xFFFFFFFF, cuda_crc.x8nmodp(len(b)))
        raw = cuda_crc.multmodp(raw_a, cuda_crc.x8nmodp(len(b))) ^ raw_b
        assert raw ^ cuda_crc.multmodp(0xFFFFFFFF, cuda_crc.x8nmodp(len(data))) ^ 0xFFFFFFFF \
            == zlib.crc32(data)


def test_plain_crc_rejects_what_the_kernel_cannot_read():
    with pytest.raises(ValueError, match="int32"):
        cuda_crc.crc32_words(torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="outside"):
        cuda_crc.crc32_words(torch.zeros(4, dtype=torch.int32), 18)


# -- a mirror of csrc/crc32.cu: keep in step with its constants and steps --

THREADS, STEPS = 256, 8  # kThreads, kSteps
TILE_VECS = THREADS * STEPS
SEGMENT_BYTES = 32 * STEPS * 16
LEVELS = 32


def _mulx(a: int) -> int:
    return (a >> 1) ^ cuda_crc.POLY if a & 1 else a >> 1


def _byte_step(crc: int, b: int) -> int:
    crc ^= b
    for _ in range(8):
        crc = _mulx(crc)
    return crc


def _tables(row0: np.ndarray, t0: np.ndarray) -> np.ndarray:
    """Rows 0..15 from row 0, each the last by one zero byte."""
    rows = [row0]
    for _ in range(15):
        rows.append((rows[-1] >> 8) ^ t0[rows[-1] & 255])
    return np.stack(rows)


def _fold16(tab: np.ndarray, crc: np.ndarray, v: np.ndarray) -> np.ndarray:
    """crc (threads,) through 16 bytes v (threads, 16) a thread."""
    w = v.astype(np.uint64)
    a = crc ^ (w[:, 0] | w[:, 1] << 8 | w[:, 2] << 16 | w[:, 3] << 24)
    out = (tab[15][a & 255] ^ tab[14][(a >> 8) & 255] ^ tab[13][(a >> 16) & 255]
           ^ tab[12][a >> 24])
    for b in range(4, 16):
        out ^= tab[15 - b][w[:, b]]
    return out


@functools.lru_cache(maxsize=1)
def _constants():
    """The host's constants and pass 1's tables: plain, and premultiplied
    by x^(8 * 496); each thread's power to its tile's end; each level's
    4-bit tables."""
    x8n, mul = cuda_crc.x8nmodp, cuda_crc.multmodp
    t0 = np.arange(256, dtype=np.uint64)
    for _ in range(8):
        t0 = (t0 >> 1) ^ (np.uint64(cuda_crc.POLY) * (t0 & 1))
    gap_basis = [mul(int(t0[1 << b]), x8n(16 * 31)) for b in range(8)]
    g0 = np.array([np.bitwise_xor.reduce([gap_basis[b] for b in range(8) if i >> b & 1] or [0])
                   for i in range(256)], np.uint64)
    plain, gap = _tables(t0, t0), _tables(g0, t0)
    t = np.arange(THREADS)
    lane, warp = t & 31, t >> 5
    to_tile_end = [x8n(16 * (31 - int(l)) + SEGMENT_BYTES * (THREADS // 32 - 1 - int(w)))
                   for l, w in zip(lane, warp)]
    nib = []
    for k in range(LEVELS):
        basis = [0] * 32
        b = x8n(TILE << k)
        for d in range(31, -1, -1):
            basis[d], b = b, _mulx(b)
        nib.append([[int(np.bitwise_xor.reduce([basis[4 * q + e] for e in range(4) if x >> e & 1] or [0]))
                     for x in range(16)] for q in range(8)])
    return plain, gap, to_tile_end, nib


def _kernel_mirror(memory: bytes, offset: int, n: int) -> int:
    """crc32.cu's CRC32 of ``memory[offset:offset + n]``, where ``offset``
    stands for the address's place against a 16-byte boundary."""
    plain, gap, to_tile_end, nib = _constants()
    n_head = min((16 - offset % 16) % 16, n)
    nv = (n - n_head) // 16
    m = -(-nv // TILE_VECS)
    data = np.frombuffer(memory, np.uint8)[offset : offset + n]
    vecs = data[n_head : n_head + 16 * nv].reshape(nv, 16)
    t = np.arange(THREADS)
    lane, warp = t & 31, t >> 5
    partials = []
    for i in range(m):
        first = nv - (m - i) * TILE_VECS + warp * 32 * STEPS + lane
        crc = np.zeros(THREADS, np.uint64)
        for j in range(STEPS):
            idx = first + 32 * j
            v = np.where((idx >= 0)[:, None], vecs[np.clip(idx, 0, None)], 0)
            crc = _fold16(gap if j < STEPS - 1 else plain, crc, v)
        x = 0
        for c, k in zip(crc.tolist(), to_tile_end):
            x ^= cuda_crc.multmodp(c, k)
        partials.append(x)

    # Pass 2: tile i's CRC through the levels the bits of m - 1 - i pick.
    body = 0
    for i, v in enumerate(partials):
        r, k = m - 1 - i, 0
        while r:
            if r & 1:
                v = functools.reduce(operator.xor, (nib[k][q][(v >> 4 * q) & 15] for q in range(8)))
            r, k = r >> 1, k + 1
        body ^= v
    crc = 0xFFFFFFFF
    for b in data[:n_head].tolist():
        crc = _byte_step(crc, b)
    crc = cuda_crc.multmodp(crc, cuda_crc.x8nmodp(16 * nv)) ^ body
    for b in data[n_head + 16 * nv :].tolist():
        crc = _byte_step(crc, b)
    return crc ^ 0xFFFFFFFF


@pytest.mark.parametrize("n", [0, 2, 14, 16, 18, 510, SEGMENT_BYTES + 2, TILE - 2, TILE, TILE + 2,
                               3 * TILE + SEGMENT_BYTES + 34])
def test_kernel_mirror_matches_zlib(n):
    """At the geometry's edges (a vector, a warp's segment, a tile, tiles
    and a ragged rest), from each of the four 4-byte places against a
    16-byte boundary (a head of 0, 12, 8 or 4 bytes)."""
    rng = np.random.default_rng(n + 1)
    memory = rng.integers(0, 256, n + 16, dtype=np.uint8).tobytes()
    for offset in (0, 4, 8, 12):
        assert _kernel_mirror(memory, offset, n) == zlib.crc32(memory[offset : offset + n]), offset


def test_kernel_mirror_on_skewed_bytes():
    """Runs of zeros and few distinct bytes, as decoded text gives."""
    rng = np.random.default_rng(5)
    data = (rng.zipf(1.5, 2 * TILE + 1000) % 7).astype(np.uint8)
    data[100:5000] = 0
    memory = data.tobytes()
    assert _kernel_mirror(memory, 0, len(memory)) == zlib.crc32(memory)


# -- decompress's check on the CPU --------------------------------------------

def _count(blob: bytes, **kwargs) -> tuple[bytes, dict]:
    before = profiling.counters().get("decompress", {})
    out = huffman_tpu_torch.decompress(blob, "cpu", **kwargs)
    after = profiling.counters()["decompress"]
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in ("crc_host", "crc_device")}


@pytest.mark.parametrize("mode", ["interleaved", "blocks"])
def test_cpu_decompress_takes_zlib(mode, monkeypatch):
    """On the CPU the check stays zlib's over the returned bytes, counted
    as ``crc_host``; ``verify_crc=False`` counts neither and launches
    nothing; the plain version is not called."""
    data = np.random.default_rng(3).integers(0, 900, 6000).astype("<u2").tobytes() + b"\x01"
    blob = huffman_tpu_torch.compress(data, "cpu", block_symbols=64, mode=mode)
    monkeypatch.setattr(bf, "crc32_words", None)  # any call would raise
    assert _count(blob) == (data, {"crc_host": 1, "crc_device": 0})
    assert _count(blob, verify_crc=False) == (data, {"crc_host": 0, "crc_device": 0})


def test_cpu_decompress_of_a_flipped_bit_raises_the_same_text():
    data = np.random.default_rng(4).integers(0, 300, 8000).astype("<u2").tobytes()
    blob = bytearray(huffman_tpu_torch.compress(data, "cpu", block_symbols=64))
    blob[len(blob) // 2] ^= 0x10  # a payload bit
    with pytest.raises(ValueError, match="^CRC mismatch: corrupt container or decode bug$"):
        huffman_tpu_torch.decompress(bytes(blob), "cpu")
