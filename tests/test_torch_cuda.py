"""The port's CUDA kernels on a card: each kernel against its plain PyTorch
version on the same CUDA tensors, and the compress routes (v2 on both
routes, v1, the reference format, codes deeper than 26 bits) against the
JAX package's host path. Exact equality throughout.

These tests need an NVIDIA card (Hopper: the kernels build for sm_90a)
and skip without one. tests/conftest.py imports JAX, which a machine set
up for the port need not have, so run them with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import types
import warnings
import zlib

import numpy as np
import pytest
import torch

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.bitio import pack_codes
from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import GROUP_LANES, MAX_SYMBOLS
from huffman_tpu.container import interleave as il
from huffman_tpu.utils.benchmark import silesia_like, zipf_pairs
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.corpus import fibonacci_pairs
from huffman_tpu_torch.ops import (
    cuda_crc,
    cuda_decode,
    cuda_encode,
    cuda_gather,
    cuda_hist,
    device_codebook,
    fused,
)
from huffman_tpu_torch.ops.tables import tables_from_codebook, tables_from_numpy
from huffman_tpu_torch.runtime import kernels
from huffman_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _streams(seed, n_real, B, alphabet_size, max_len):
    rng = np.random.default_rng(seed)
    n_lanes = -(-n_real // GROUP_LANES) * GROUP_LANES
    n_pairs = n_real * B - int(rng.integers(1, B))
    alphabet = rng.choice(MAX_SYMBOLS, size=alphabet_size, replace=False)
    symbols = np.concatenate([alphabet, rng.choice(alphabet, n_pairs - alphabet_size)])
    symbols = symbols.astype(np.uint16)
    cb = Codebook.from_lengths(
        package_merge_lengths(np.bincount(symbols, minlength=MAX_SYMBOLS), max_len)
    )
    lens = cb.lengths[symbols].astype(np.int64)
    rows = [
        pack_codes(cb.codes[symbols[l * B : (l + 1) * B]], lens[l * B : (l + 1) * B])[0]
        for l in range(n_real)
    ]
    slab = np.zeros((n_lanes, max(r.size for r in rows)), np.uint32)
    for i, r in enumerate(rows):
        slab[i, : r.size] = r
    padded = np.zeros(n_lanes * B, np.int64)
    padded[:n_pairs] = lens
    eff = il.effective_lengths(padded.reshape(n_lanes, B), n_pairs,
                               int(cb.lengths[cb.lengths > 0].min()), n_lanes, B)
    streams = il.build_interleaved_streams(slab, eff, n_real)
    return symbols, cb, streams


@pytest.mark.parametrize("alphabet,max_len", [(1, 12), (2, 12), (300, 12), (1024, 18),
                                              (1025, 18), (4000, 12), (30000, 18)])
def test_decode_kernels_match_plain(dev, alphabet, max_len):
    B, n_real = 64, 2500
    symbols, cb, streams = _streams(alphabet, n_real, B, alphabet, max_len)
    stacked, _ = il.pad_streams(streams)
    ngroups = len(streams)
    s = torch.from_numpy(stacked.reshape(ngroups, -1).view(np.int32)).to(dev)
    n = torch.from_numpy(
        np.clip(n_real - GROUP_LANES * np.arange(ngroups), 0, GROUP_LANES).astype(np.int32)
    ).to(dev)
    t = tables_from_codebook(cb, dev)
    translate = cb.n_unique <= cuda_decode.TRANSLATE_MAX_ALPHABET
    got = cuda_decode.decode_groups(s, n, t, B, translate)
    want = cuda_decode.decode_groups_plain(s, n, t, B, translate)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if not translate:
        got = cuda_gather.gather_u16_pairs(got, t.sym_order)
        assert torch.equal(got, cuda_gather.gather_u16_pairs_plain(want, t.sym_order))
    words = got.reshape(ngroups, B // 2, GROUP_LANES).transpose(1, 2).contiguous()
    dec = words.cpu().numpy().view("<u2").reshape(-1)[: symbols.size]
    np.testing.assert_array_equal(dec, symbols)


def test_gather_kernels_match_plain(dev):
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 100_003, dtype=np.int64)
                           .astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, 5000).astype(np.int16)).to(dev)
    assert torch.equal(cuda_gather.gather_u16_pairs(idx, table),
                       cuda_gather.gather_u16_pairs_plain(idx, table))
    sym = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (777, 130)).astype(np.int16)).to(dev)
    enc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 1 << 16).astype(np.int32)).to(dev)
    for n_valid in (0, 12345, sym.numel()):
        got = cuda_gather.gather_codes(sym, enc, n_valid)
        want = cuda_gather.gather_codes_plain(sym, enc, n_valid)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("B", [2, 30, 512])
def test_pack_kernel_matches_plain(dev, B):
    rng = np.random.default_rng(B)
    lens = rng.integers(0, 33, size=(3000, B))
    codes = rng.integers(0, 1 << 32, size=lens.shape, dtype=np.uint64) & (
        (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    )
    c = torch.from_numpy(codes.astype(np.uint32).view(np.int32)).to(dev)
    l = torch.from_numpy(lens.astype(np.int32)).to(dev)
    assert torch.equal(cuda_encode.pack_lanes(c, l), cuda_encode.pack_lanes_plain(c, l))


def _deep_tables(shortest, seed, dev):
    """Decode tables with every length in shortest..32 (1000 symbols),
    sorted random boundaries and a random base: on random stream bits
    nearly every lane consumes 29-32 bits a step, so nearly all refill
    every step (all of them when shortest is 32). The kernel's contract
    holds for any tables, not only those of a complete code."""
    rng = np.random.default_rng(seed)
    lengths = np.zeros(MAX_SYMBOLS, np.uint8)
    lengths[:1000] = rng.integers(shortest, 33, 1000)
    lj = np.full(32, 0xFFFFFFFF, np.uint32)
    lj[shortest - 1 : 31] = np.sort(rng.integers(0, 1 << 32, 32 - shortest, dtype=np.uint64))
    return tables_from_numpy(lengths, np.zeros(MAX_SYMBOLS, np.uint32), lj,
                             rng.integers(-(1 << 40), 1 << 40, 33), np.arange(1000, dtype=np.uint16), dev)


@pytest.mark.parametrize("case", ["ring wraps, all lanes refill", "ring wraps, 29-32 bits",
                                  "unaligned width and row start", "more groups than SMs"])
@pytest.mark.parametrize("translate", [True, False])
def test_decode_kernel_edges(dev, case, translate):
    """K1 against its plain version on random stream bits at the edges of
    its stream ring and of its grid: 2048 steps that consume up to 1024
    words each (the 16K-word ring wraps 128 times), a width W that is not
    a multiple of 4 words with the stream read past its end, rows that
    start off a 16-byte boundary, and 200 groups with a short last one."""
    rng = np.random.default_rng(len(case) + translate)
    B, ngroups = (2048, 2) if case.startswith("ring") else (8, 200) if case.startswith("more") else (64, 3)
    if case.startswith("ring wraps, all"):
        t = _deep_tables(32, 1, dev)
    elif case.startswith("ring"):
        t = _deep_tables(29, 2, dev)
    else:
        _, cb, _ = _streams(4, 2500, 8, 1000 if translate else 4000, 18)
        t = tables_from_codebook(cb, dev)
    W = 2 * GROUP_LANES + (B * GROUP_LANES if case.startswith("ring") else 4099)
    flat = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, ngroups * W + 1).astype(np.int32)).to(dev)
    s = flat[1:].view(ngroups, W)  # contiguous, data 4 bytes past the allocation
    n = torch.from_numpy(rng.integers(0, GROUP_LANES + 1, ngroups).astype(np.int32))
    n[-1] = 77
    n = n.to(dev)
    kernels.reset_launch_counts()
    got = cuda_decode.decode_groups(s, n, t, B, translate)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_groups"] == 1
    assert torch.equal(got, cuda_decode.decode_groups_plain(s, n, t, B, translate))


TRANSLATE_CASES = [(n, g, 0) for n in (1025, 4096, 30000, 65536) for g in (32, 160)] + [
    (65536, 32, 1), (30000, 32, 3),  # the table 2 and 6 bytes past a 16-byte boundary
]


@pytest.mark.parametrize("n_sym,ngroups,offset", [
    c for c in TRANSLATE_CASES if c[0] <= cuda_decode.TRANSLATE_MAX_ALPHABET
])
def test_translate_kernel_at_capacity(dev, n_sym, ngroups, offset):
    """K1 in translate mode with its symbol table in dynamic shared memory,
    sized from the alphabet, against its plain version and against rank
    mode + K2, at 32 groups and at 160 (more blocks than SMs: the streams
    repeated along the groups); the table also as a view off a 16-byte
    boundary (its plain-load path)."""
    B = 4
    symbols, cb, streams = _streams(n_sym, 32 * GROUP_LANES, B, n_sym, 18)
    assert cb.n_unique == n_sym
    stacked, _ = il.pad_streams(streams)
    s = torch.from_numpy(stacked.reshape(32, -1).view(np.int32)).to(dev).repeat(ngroups // 32, 1)
    n = torch.full((ngroups,), GROUP_LANES, dtype=torch.int32, device=dev)
    t = tables_from_codebook(cb, dev)
    if offset:
        padded = torch.cat([torch.zeros(offset, dtype=torch.int16, device=dev), t.sym_order])
        t = t._replace(sym_order=padded[offset:])
        assert t.sym_order.data_ptr() % 16 == 2 * offset
    kernels.reset_launch_counts()
    got = cuda_decode.decode_groups(s, n, t, B, True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_groups"] == 1
    assert torch.equal(got, cuda_decode.decode_groups_plain(s, n, t, B, True))
    rank = cuda_gather.gather_u16_pairs(cuda_decode.decode_groups(s, n, t, B, False), t.sym_order)
    assert torch.equal(got, rank)
    words = got[:32].reshape(32, B // 2, GROUP_LANES).transpose(1, 2).contiguous()
    np.testing.assert_array_equal(words.cpu().numpy().view("<u2").reshape(-1)[: symbols.size], symbols)


def test_translate_kernel_from_two_threads(dev):
    """Two host threads decode streams of different alphabets (a 2 KiB and
    a 128 KiB table) in translate mode, 200 times each: every launch runs
    and gives the same words (the shared-memory opt-in is the kernel's, so
    one thread's launch must not change what the other's may use)."""
    import threading

    B = 4
    cases = []
    for seed, n_sym in ((1025, 1025), (65536, 65536)):
        _, cb, streams = _streams(seed, 32 * GROUP_LANES, B, n_sym, 18)
        stacked, _ = il.pad_streams(streams)
        s = torch.from_numpy(stacked.reshape(32, -1).view(np.int32)).to(dev)
        n = torch.full((32,), GROUP_LANES, dtype=torch.int32, device=dev)
        t = tables_from_codebook(cb, dev)
        cases.append((s, n, t, cuda_decode.decode_groups_plain(s, n, t, B, True)))
    errors = []

    def run(s, n, t, want):
        try:
            for _ in range(200):
                got = cuda_decode.decode_groups(s, n, t, B, True)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
        except BaseException as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=c) for c in cases]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors


@pytest.mark.parametrize("n_lanes,B,kind", [(1, 1, "mixed"), (13, 2, "mixed"), (1001, 30, "mixed"),
                                            (3001, 512, "mixed"), (37, 4099, "mixed"),
                                            (259, 512, "runs32"), (259, 513, "runs0"),
                                            (259, 64, "boundary")])
def test_pack_kernel_edges(dev, n_lanes, B, kind):
    """K4 against its plain version: any B (4099 is many 128-step tiles),
    lane counts that are not a multiple of the block's 8 rows, runs of
    32-bit codes, runs of L = 0, and lanes ending exactly on a word."""
    rng = np.random.default_rng(n_lanes + B)
    lens = rng.integers(0, 33, size=(n_lanes, B))
    run = slice(B // 4, max(3 * B // 4, B // 4 + 1))
    if kind == "runs32":
        lens[:, run] = 32
    elif kind == "runs0":
        lens[:, run] = 0
    elif kind == "boundary":
        lens[::2, -1] = (-lens[::2, :-1].sum(axis=1)) % 32
    codes = rng.integers(0, 1 << 32, size=lens.shape, dtype=np.uint64) & (
        (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    )
    c = torch.from_numpy(codes.astype(np.uint32).view(np.int32)).to(dev)
    l = torch.from_numpy(lens.astype(np.int32)).to(dev)
    got = cuda_encode.pack_lanes(c, l)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_encode.pack_lanes_plain(c, l))


def _slice_inputs():
    return {
        "silesia_like_4MiB": silesia_like(4 << 20, seed=7).tobytes(),
        "zipf30k_4MiB": zipf_pairs(4 << 20, 30000, np.random.default_rng(3)).tobytes(),
        "zipf300_odd": zipf_pairs(1 << 20, 300, np.random.default_rng(5)).tobytes() + b"\x01",
        "empty": b"",
        "one_byte": b"\xff",
        "single_symbol": b"zz" * 70000,
        "random_bytes": np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("name", sorted(_slice_inputs()))
def test_slice_matches_host_path(dev, name):
    data = _slice_inputs()[name]
    kernels.reset_launch_counts()
    blob = huffman_tpu_torch.compress(data, dev)
    assert blob == huffman_tpu.compress(data, backend="numpy")
    assert huffman_tpu_torch.decompress(blob, dev) == data
    if len(blob) < len(data) and len(data) > 2:
        counts = kernels.launch_counts()
        fused_route = len(data) // 2 >= bf.DEVICE_MIN_PAIRS
        gathers = ("gather_rank_select", "gather_rank_canonical") if fused_route else ("gather_codes",)
        assert any(counts[k] for k in gathers)
        assert counts["pack_lanes"] and counts["decode_groups"]
        assert bool(counts["histogram"]) == fused_route
        assert counts["crc32_words"] == counts["decode_groups"] == 1  # decompress's CRC32 on the card


def test_slice_at_benchmark_size(dev):
    """32 MiB, the size of the repo's benchmark corpora: the fused route,
    one input per gather scheme (rank-select, canonical rank, identity)."""
    for data, tier in ((silesia_like(32 << 20, seed=7).tobytes(), 4096),
                       (zipf_pairs(32 << 20, 30000, np.random.default_rng(3)).tobytes(), 32768),
                       (zipf_pairs(32 << 20, 65536, np.random.default_rng(11)).tobytes(), 65536)):
        kernels.reset_launch_counts()
        blob = huffman_tpu_torch.compress(data, dev)
        counts = kernels.launch_counts()
        assert counts["histogram"] == 1 and counts["package_merge"] == 1
        assert counts["gather_rank_select" if tier < fused.CANON_GATHER_MIN_CAP else "gather_rank_canonical"] == 1
        assert blob == huffman_tpu.compress(data, backend="numpy")
        assert huffman_tpu_torch.decompress(blob, dev) == data


def _symbols(n_unique, n, seed, skew=0.0):
    """(n,) u16 symbols holding exactly n_unique distinct values."""
    rng = np.random.default_rng(seed)
    alpha = rng.choice(MAX_SYMBOLS, n_unique, replace=False)
    p = 1.0 / np.arange(1, n_unique + 1) ** skew
    body = rng.choice(alpha, n - n_unique, p=p / p.sum())
    return np.concatenate([alpha, body]).astype(np.uint16)


def _padded(sym, B=64):
    """(n_lanes, B) int16 symbols zero-padded to whole groups of lanes."""
    nblocks = -(-sym.size // B)
    n_lanes = -(-nblocks // GROUP_LANES) * GROUP_LANES
    out = np.zeros(n_lanes * B, np.uint16)
    out[: sym.size] = sym
    return torch.from_numpy(out.view(np.int16)).reshape(n_lanes, B)


@pytest.mark.parametrize("n,n_unique,skew,offset", [
    (1, 1, 0.0, 0), (1000, 7, 0.0, 0), (65535, 4096, 1.1, 0), (3 * 65536 + 7, 65536, 0.0, 0),
    (1 << 22, 1, 0.0, 0), ((1 << 24) + 5, 4000, 1.1, 0),
    # n % 8 == 1 .. 7, the view 2 to 14 bytes past a 16-byte boundary
    *[(8 * 40000 + r, 4096, 1.1, r) for r in range(1, 8)],
    ((1 << 24), 1, 0.0, 1),     # one hot bin: 2^24 symbols, unaligned
    (16 << 20, 65536, 0.0, 0),  # all 65,536 bins at the full-alphabet size (32 MiB)
])
def test_histogram_kernel_matches_plain(dev, n, n_unique, skew, offset):
    sym = _symbols(n_unique, n, n, skew)
    padded = _padded(sym).reshape(-1)
    t = torch.cat([torch.zeros(offset, dtype=torch.int16), padded]).to(dev)[offset:]
    got = cuda_hist.histogram(t, n)
    want = cuda_hist.histogram_plain(t, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), torch.from_numpy(np.bincount(sym, minlength=MAX_SYMBOLS).astype(np.int32)))


@pytest.mark.parametrize("n_unique,max_len,n_sym,K", [
    (n, max_len, MAX_SYMBOLS, None) for n in (0, 1, 2, 4096, 4097, 16384, 32769, 65536) for max_len in (16, 26)
] + [
    (4095, 18, MAX_SYMBOLS, None), (4096, 32, MAX_SYMBOLS, None),  # one block: its last tier, 31 rounds
    (65536, 32, MAX_SYMBOLS, None),  # the launch chain at 31 rounds
    (256, 16, 256, 256), (1000, 18, 1024, 1024),  # one block at K = n_sym
    (500, 18, 512, 512), (2000, 18, MAX_SYMBOLS, 2048),  # one block, 1 and 4 outputs a thread
    (5000, 18, MAX_SYMBOLS, 4096),  # n > K: the launch chain at K = 4096
])
def test_package_merge_kernel_matches_plain(dev, n_unique, max_len, n_sym, K):
    rng = np.random.default_rng(n_unique + max_len)
    freqs = np.zeros(n_sym, np.int32)
    freqs[rng.choice(n_sym, n_unique, replace=False)] = rng.integers(1, 1 << 12, n_unique)  # sum < 2**30
    if 40 <= n_unique:  # a Fibonacci head: the length limit binds
        fib = [1, 1]
        while len(fib) < 30:
            fib.append(fib[-1] + fib[-2])
        freqs[np.flatnonzero(freqs)[:30]] = fib
    f = torch.from_numpy(freqs).to(dev)
    K = K or fused.tier_for(max(n_unique, 1))
    got = device_codebook.package_merge(f, n_unique, max_len, K)
    want = device_codebook.package_merge_plain(f, n_unique, max_len, K)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if n_sym == MAX_SYMBOLS and n_unique <= K:
        lengths = device_codebook.device_code_lengths(f, max_len, K, n_unique)
        np.testing.assert_array_equal(lengths.cpu().numpy(), package_merge_lengths(freqs, max_len))


@pytest.mark.parametrize("n_unique", [1, 4096, 4097, 16384, 32769, 65536])
@pytest.mark.parametrize("max_len", [16, 26])
def test_rank_gather_kernels_match_plain(dev, n_unique, max_len, monkeypatch):
    """tiered_code_gather on the card against the CPU's plain versions, and
    each rank-gather kernel against its plain version on the card's
    tensors; n_valid is not a multiple of the kernels' block."""
    sym = _symbols(n_unique, 3 * 65536 + 11, n_unique, 0.7)
    t = _padded(sym)
    n_valid = sym.size - 5
    hist = cuda_hist.histogram_plain(t, n_valid)
    nu = int((hist > 0).sum())
    calls = {}
    for k in ("gather_rank_select", "gather_rank_canonical"):
        def record(*a, _k=k, _fn=getattr(fused, k)):
            calls[_k] = a
            return _fn(*a)

        monkeypatch.setattr(fused, k, record)
    got = fused.tiered_code_gather(hist.to(dev), nu, t.to(dev), n_valid, max_len=max_len)
    monkeypatch.undo()
    want = fused.tiered_code_gather(hist, nu, t, n_valid, max_len=max_len)
    assert got[3] == want[3] == fused.tier_for(nu)
    for i in range(3):
        assert torch.equal(got[i].cpu(), want[i])
    (name, args), = calls.items()
    plain = getattr(cuda_gather, name + "_plain")
    kern = getattr(cuda_gather, name)
    assert all(torch.equal(a, b) for a, b in zip(kern(*args), plain(*args)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset,n,n_valid,max_len,n_unique,identity,table", [
    (1, 3 * 65536 + 11, 3 * 65536 + 6, 18, 20000, False, "whole"),  # view 1 u16 past a 16-byte boundary
    (3, 3 * 65536 + 11, 3 * 65536 + 6, 18, 40000, True, "whole"),   # 3 u16 past
    (2, 1001, 998, 26, None, False, "whole"),   # n below one block's batch of 32,768 symbols
    (4, 5, 0, 18, None, True, "whole"),         # the tail alone, n_valid 0
    (0, 40003, 0, 26, None, False, "whole"),    # n_valid 0
    (1, 70001, 3, 1, None, False, "whole"),     # max_len 1: a single symbol
    (3, 70001, 60000, 1, None, True, "whole"),
    (0, (1 << 20) + 3, (1 << 20) - 100, 26, None, True, "whole"),  # codes of 26 bits, empty length classes
    (2, (1 << 24) + 1, (1 << 24) - 7, 26, 16000, False, "whole"),  # several grid steps, unaligned
    (1, 70001, 69000, 18, 20000, False, "unaligned"),  # tables copied by the threads
    (3, 70001, 69000, 18, None, True, "unaligned"),
    (0, 70001, 69000, 18, 20000, False, "ragged"),     # canon16 of 16,382 words: 2 past the bulk copy
])
def test_rank_canonical_kernel_edges(dev, offset, n, n_valid, max_len, n_unique, identity, table):
    """K9 against its plain version on the card's tensors, with absent
    symbols (a fifth of the positions, any of the 65,536 values) before
    and past n_valid. Lengths: package-merge of n_unique random
    frequencies, or (None) three codes at each even length below
    max_len - 1 and four at max_len, every odd length an empty class.
    Tables: as the fused route builds them, or (``unaligned``) canon16,
    mask and cums as views 4 bytes past a 16-byte boundary, or
    (``ragged``) canon16 cut to a length that is not a multiple of 4."""
    rng = np.random.default_rng(n + offset)
    lengths = np.zeros(MAX_SYMBOLS, np.int64)
    if max_len == 1:
        lengths[rng.integers(MAX_SYMBOLS)] = 1
    elif n_unique is None:
        ls = [l for l in range(2, max_len - 1, 2) for _ in range(3)] + [max_len] * 4
        lengths[rng.choice(MAX_SYMBOLS, len(ls), replace=False)] = ls
    else:
        freqs = np.zeros(MAX_SYMBOLS, np.int64)
        freqs[rng.choice(MAX_SYMBOLS, n_unique, replace=False)] = rng.integers(1, 500, n_unique)
        lengths = package_merge_lengths(freqs, max_len).astype(np.int64)
    t = device_codebook.device_canonical_tables(torch.from_numpy(lengths.astype(np.int32)))
    if identity:
        ranks = t.sym_rank.to(torch.int64)
        maskw = cums = torch.zeros(2048, dtype=torch.int32)
    else:
        maskw, cums, dense = cuda_gather.build_rank_select(t.sym_rank, torch.from_numpy(lengths > 0), 32768)
        ranks = dense.to(torch.int64) & 0xFFFFFFFF
    canon16 = (ranks[0::2] | (ranks[1::2] << 16)).to(torch.int32)
    if table == "ragged":
        canon16 = canon16[:-2]
    tabs = [x.to(dev) for x in (maskw, cums, canon16)]
    if table == "unaligned":
        tabs = [torch.cat([torch.zeros(1, dtype=torch.int32), x]).to(dev)[1:] for x in (maskw, cums, canon16)]
        assert all(x.data_ptr() % 16 == 4 for x in tabs)
    buf = rng.choice(np.flatnonzero(lengths), offset + n).astype(np.uint16)
    buf[offset + rng.choice(n, n // 5)] = rng.integers(0, MAX_SYMBOLS, n // 5)
    sym = torch.from_numpy(buf.view(np.int16)).to(dev)[offset:]
    args = (sym, n_valid, *tabs, t.start.to(dev), t.base.to(dev), max_len, identity)
    kernels.reset_launch_counts()
    got = cuda_gather.gather_rank_canonical(*args)
    assert kernels.launch_counts()["gather_rank_canonical"] == 1
    want = cuda_gather.gather_rank_canonical_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if n <= 1 << 20:
        cpu = cuda_gather.gather_rank_canonical(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))


@pytest.mark.parametrize("n_table", [1, 2, 3000, 65536])
def test_gather_u16_kernel_matches_plain(dev, n_table):
    """Any shape, indices far outside the table, element counts that are
    not a multiple of four, and a view that is not 16-byte aligned (the
    kernel's scalar path)."""
    rng = np.random.default_rng(n_table)
    table = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, n_table).astype(np.int16)).to(dev)
    idx = torch.from_numpy(
        np.concatenate([rng.integers(-5, n_table + 5, 70_001), rng.integers(-(1 << 31), 1 << 31, 999)])
        .astype(np.int32)
    ).to(dev)
    for x in (idx, idx[1:], idx[:7].reshape(7, 1), idx[:3 * 8 * 128].reshape(3, 8, 128)):
        got = cuda_gather.gather_u16(x, table)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_gather.gather_u16_plain(x, table))


def _protocol_case(seed, n_real, B, min_len, max_len, n_groups):
    """(codes, eff) with random codes of random lengths on the real steps
    and code 0 with ``min_len`` on the garbage steps."""
    rng = np.random.default_rng(seed)
    n_lanes = n_groups * GROUP_LANES
    n_pairs = n_real * B - int(rng.integers(0, B))
    lens = rng.integers(min_len, max_len + 1, size=(n_lanes, B)).astype(np.int32)
    codes = (rng.integers(0, 1 << 32, size=(n_lanes, B), dtype=np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    valid = (np.arange(n_lanes * B) < n_pairs).reshape(n_lanes, B)
    codes = np.where(valid, codes, 0).astype(np.uint32)
    eff = np.where(valid, lens, min_len).astype(np.int32)
    return torch.from_numpy(codes.view(np.int32)), torch.from_numpy(eff)


@pytest.mark.parametrize("seed,n_real,B,min_len,max_len,n_groups", [
    (0, 1, 32, 5, 12, 1),        # one real lane
    (1, 1024, 16, 32, 32, 1),    # all-32-bit codes: every step fires
    (2, 2400, 37, 1, 32, 3),     # three groups, B not a multiple of 32
    (3, 3000, 512, 1, 18, 3),    # the container's block size
    (4, 700, 16, 1, 2, 1),       # lanes with fewer than 64 bits
    (5, 140 * 1024, 512, 1, 3, 140),  # more groups than SMs, sparse fires
])
def test_deposit_kernel_matches_plain(dev, seed, n_real, B, min_len, max_len, n_groups):
    """K10 against its plain version and the deposit path against the
    tensor-op pack_streams, at the tight cap (the largest group's body)
    and at a loose one."""
    codes, eff = _protocol_case(seed, n_real, B, min_len, max_len, n_groups)
    c, e = codes.to(dev), eff.to(dev)
    _, counts = cuda_encode.pack_streams(c, e, n_real, B * GROUP_LANES)
    tight = max(int(counts.max()) - 2 * GROUP_LANES, 1)
    for cap in (tight, B * GROUP_LANES):
        ref_s, ref_c = cuda_encode.pack_streams(c, e, n_real, cap)
        kernels.reset_launch_counts()
        got_s, got_c = cuda_encode.pack_streams_kernel_deposit(c, e, n_real, cap)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["deposit_streams"] == 1
        assert torch.equal(got_c, ref_c)
        for g, n in enumerate(ref_c.tolist()):
            assert torch.equal(got_s[g, :n], ref_s[g, :n])
            assert not got_s[g, n:].any()
        r, fire = cuda_encode._fires(e, n_real)
        st = cuda_encode.pack_lanes(c, e)
        mb = -(-B // 32)
        mask = torch.nn.functional.pad(fire, (0, mb * 32 - B)).reshape(-1, mb, 32).to(torch.int64)
        mask = (mask << torch.arange(32, device=dev)).sum(dim=2)
        mask = torch.where(mask >= 1 << 31, mask - (1 << 32), mask).to(torch.int32)
        body = r[:, -1].reshape(-1, GROUP_LANES).sum(dim=1, dtype=torch.int32)
        assert torch.equal(cuda_encode.deposit_streams(st, mask, body, cap),
                           cuda_encode.deposit_streams_plain(st, mask, body, cap))
        # Body word counts that disagree with the fire bits: below them the
        # first fires' slots fall below 0 and are dropped, above them the
        # first slots stay zero.
        for shift in (-40, 40):
            off = (body + shift).clamp(max=cap)
            assert torch.equal(cuda_encode.deposit_streams(st, mask, off, cap),
                               cuda_encode.deposit_streams_plain(st, mask, off, cap))


def _unpacked_case(dev, alphabet, max_len):
    B, n_real = 64, 2500
    symbols, cb, streams = _streams(alphabet, n_real, B, alphabet, max_len)
    stacked, _ = il.pad_streams(streams)
    ngroups = len(streams)
    s = torch.from_numpy(stacked.reshape(ngroups, -1).view(np.int32)).to(dev)
    n = torch.from_numpy(
        np.clip(n_real - GROUP_LANES * np.arange(ngroups), 0, GROUP_LANES).astype(np.int32)
    ).to(dev)
    return symbols, cb, s, n, B


@pytest.mark.parametrize("alphabet", [300, 4000, 65536])
def test_unpacked_decode_on_the_card(dev, alphabet):
    symbols, cb, s, n, B = _unpacked_case(dev, alphabet, 18)
    t = tables_from_codebook(cb, dev)
    translate = cb.n_unique <= cuda_decode.TRANSLATE_MAX_ALPHABET
    kernels.reset_launch_counts()
    got = cuda_decode.decode_groups(s, n, t, B, translate, packed_out=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_u16"] == int(not translate)
    ngroups = s.shape[0]
    dec = got.reshape(ngroups, B, GROUP_LANES).transpose(1, 2).reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(dec[: symbols.size], symbols)


@pytest.mark.parametrize("alphabet", [300, 4000, 65536])
def test_unpacked_rank_decode_on_the_card(dev, alphabet):
    """``packed_out=False`` in rank mode at every alphabet size: K1's
    ranks, unpacked, through K5."""
    symbols, cb, s, n, B = _unpacked_case(dev, alphabet, 18)
    t = tables_from_codebook(cb, dev)
    kernels.reset_launch_counts()
    got = cuda_decode.decode_groups(s, n, t, B, False, packed_out=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_u16"] == 1
    ngroups = s.shape[0]
    dec = got.reshape(ngroups, B, GROUP_LANES).transpose(1, 2).reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(dec[: symbols.size], symbols)


def _route_sizes(monkeypatch):
    """A 2 MiB input on the fused route (its pair threshold lowered)."""
    monkeypatch.setattr(bf, "DEVICE_MIN_PAIRS", 1 << 16)
    return silesia_like(2 << 20, seed=3).tobytes() + b"\x05"


@pytest.mark.parametrize("route", ["fused", "host codebook", "htpx per-shard"])
def test_compress_routes_assemble_streams_by_deposit(dev, route, monkeypatch):
    """A small compress on each v2 route (the fused route, a given
    codebook, HTPX shards) writes the CPU path's bytes (and the JAX
    package's) and assembles its streams with K4 + K10, then decodes in
    translate mode without K2."""
    from huffman_tpu_torch.container import sharded

    data = _route_sizes(monkeypatch)
    if route == "fused":
        run = lambda d: huffman_tpu_torch.compress(data, d)  # noqa: E731
        want = huffman_tpu.compress(data, backend="numpy")
    elif route == "host codebook":
        cb = bf.ParsedContainer(huffman_tpu_torch.compress(data, "cpu")).codebook
        run = lambda d: huffman_tpu_torch.compress(data, d, codebook=cb)  # noqa: E731
        want = None
    else:
        run = lambda d: sharded.compress(data, n_shards=3, codebook_mode="per-shard", device=d)  # noqa: E731
        want = None
    kernels.reset_launch_counts()
    blob = run(dev)
    counts = kernels.launch_counts()
    assert counts["pack_lanes"] >= 1 and counts["deposit_streams"] == counts["pack_lanes"]
    assert bool(counts["histogram"]) == (route != "host codebook")  # HTPX's shards take the fused route
    assert blob == run("cpu")
    if want is not None:
        assert blob == want
    kernels.reset_launch_counts()
    assert huffman_tpu_torch.decompress(blob, dev) == data
    counts = kernels.launch_counts()
    assert counts["decode_groups"] >= 1 and counts["gather_u16_pairs"] == 0
    assert counts["crc32_words"] == counts["decode_groups"]  # one CRC32 a container (HTPX: a shard)


def test_v1_reference_and_deep_codes_at_benchmark_size(dev):
    """32 MiB v1 and reference containers, and the 29-bit Fibonacci input
    in v2 and v1, byte-identical to the JAX package's host path."""
    data = silesia_like(32 << 20, seed=7).tobytes()
    kernels.reset_launch_counts()
    blob = huffman_tpu_torch.compress(data, dev, mode="blocks")
    assert kernels.launch_counts()["gather_codes"] == 1
    assert blob == huffman_tpu.compress(data, backend="numpy", mode="blocks")
    assert huffman_tpu_torch.decompress(blob, dev) == data
    ref = huffman_tpu_torch.compress_reference(data, dev)
    assert ref == huffman_tpu.compress_reference(data)
    assert huffman_tpu.decompress_reference(ref) == data

    fib = fibonacci_pairs().tobytes()
    for mode in ("interleaved", "blocks"):
        blob = huffman_tpu_torch.compress(fib, dev, max_code_len=None, mode=mode)
        assert blob[7] == 29
        assert blob == huffman_tpu.compress(fib, backend="numpy", max_code_len=None, mode=mode)
        assert huffman_tpu_torch.decompress(blob, dev) == fib
    assert huffman_tpu_torch.compress_reference(fib, dev) == huffman_tpu.compress_reference(fib)


def test_htps_and_htpx_on_the_card_equal_the_host_path(dev):
    """HTPS chunks of 4 MiB (the fused route, two in flight) and HTPX
    archives in both codebook modes (global: the host-codebook route;
    per-shard: fused shards)."""
    from huffman_tpu.container import sharded as jax_sharded
    from huffman_tpu.container import streaming as jax_streaming
    from huffman_tpu_torch.container import sharded, streaming

    data = silesia_like(12 << 20, seed=7).tobytes() + b"\x01"
    kernels.reset_launch_counts()
    blobs = [streaming.compress_bytes(data, chunk_bytes=4 << 20, device=dev, pipeline=p)
             for p in (1, 2)]
    counts = kernels.launch_counts()
    # Three fused chunks a call; the one-byte fourth chunk has no pairs.
    assert counts["histogram"] == 6 and counts["pack_lanes"] == 6
    want = jax_streaming.compress_bytes(data, chunk_bytes=4 << 20, backend="numpy")
    assert blobs == [want, want]
    for p in (1, 2):
        assert streaming.decompress_bytes(want, device=dev, pipeline=p) == data
    for mode in ("global", "per-shard"):
        kernels.reset_launch_counts()
        blob = sharded.compress(data, n_shards=3, codebook_mode=mode, device=dev)
        counts = kernels.launch_counts()
        assert bool(counts["gather_codes"]) == (mode == "global")
        assert bool(counts["histogram"]) == (mode == "per-shard")
        assert blob == jax_sharded.compress(data, n_shards=3, codebook_mode=mode, backend="numpy")
        assert huffman_tpu_torch.decompress(blob, dev) == data


def test_htps_pool_threads_upload_from_their_own_pinned_buffers(dev, monkeypatch):
    """HTPS decode with two records in flight over records of two sizes
    (4 MiB chunks and a shorter last one): each pool thread fills and
    uploads from a pinned buffer of its own, and downloads the decoded
    symbols into another pinned buffer of its own."""
    import threading

    from huffman_tpu_torch.container import streaming
    from huffman_tpu_torch.corpus import silesia_like as port_silesia_like

    data = port_silesia_like(10 << 20, seed=5).tobytes() + b"\x02"
    blob = streaming.compress_bytes(data, chunk_bytes=4 << 20, device=dev)
    served: list[tuple[str, int, int, bool]] = []
    host_buffer = bf._host_buffer

    def recording(purpose, n_bytes, pinned):
        buf = host_buffer(purpose, n_bytes, pinned)
        served.append((purpose, threading.get_ident(), buf.data_ptr(), buf.is_pinned()))
        return buf

    monkeypatch.setattr(bf, "_host_buffer", recording)
    for _ in range(2):
        served.clear()
        kernels.reset_launch_counts()
        assert streaming.decompress_bytes(blob, device=dev, pipeline=2) == data
        assert kernels.launch_counts()["crc32_words"] == 3  # each record's CRC32 on the card
        ends = []
        for purpose in ("upload", "download"):
            mine = [s[1:] for s in served if s[0] == purpose]
            assert len(mine) == 3 and all(pinned for _, _, pinned in mine)
            last = {thread: ptr for thread, ptr, _ in mine}  # each thread's buffer at the end
            assert 1 <= len(last) <= 2
            ends += last.values()
        assert len(set(ends)) == len(ends)  # no buffer shared by two threads or two purposes


def _recording_zlib(monkeypatch) -> list[int]:
    """``block_format``'s zlib with a ``crc32`` that records the length of
    each buffer it is given."""
    lengths: list[int] = []

    def crc32(data, value=0):
        lengths.append(len(data))
        return zlib.crc32(data, value)

    monkeypatch.setattr(bf, "zlib", types.SimpleNamespace(crc32=crc32))
    return lengths


def _crc_counts(fn) -> dict:
    before = profiling.counters().get("decompress", {})
    fn()
    after = profiling.counters()["decompress"]
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("crc_device", "crc_host")}


def test_corrupt_payload_fails_crc_on_the_card(dev, monkeypatch):
    """A container with one flipped payload bit decodes on the card and
    fails the CRC32 check, taken on the card (``crc_device``; zlib in
    ``block_format`` reads nothing, the odd last byte included), with the
    CPU's text."""
    from huffman_tpu_torch.corpus import silesia_like as port_silesia_like

    data = port_silesia_like(4 << 20, seed=9).tobytes() + b"\x03"
    blob = bytearray(huffman_tpu_torch.compress(data, dev))
    lengths = _recording_zlib(monkeypatch)
    out = []
    assert _crc_counts(lambda: out.append(huffman_tpu_torch.decompress(bytes(blob), dev))) == \
        {"crc_device": 1, "crc_host": 0}
    assert out == [data]
    blob[len(blob) // 2] ^= 0x10  # a payload bit
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="^CRC mismatch: corrupt container or decode bug$"):
        huffman_tpu_torch.decompress(bytes(blob), dev)
    assert kernels.launch_counts()["crc32_words"] == 1
    assert lengths == []


CRC_LENGTHS = [2, 14, 16, 18, 510, 4098, cuda_crc.TILE_BYTES - 2, cuda_crc.TILE_BYTES,
               cuda_crc.TILE_BYTES + 2, 5 * cuda_crc.TILE_BYTES + 4098 + 6]


@pytest.mark.parametrize("n", CRC_LENGTHS)
def test_crc32_kernel_matches_plain_and_zlib(dev, n):
    """K11 against its plain version and zlib at lengths off a 16-byte
    vector, a warp's 4 KiB and a block's tile, from each of the four
    4-byte places against a 16-byte boundary (heads of 0, 12, 8 and 4
    bytes before the first aligned vector)."""
    raw = np.random.default_rng(n).integers(0, 256, (n + 35) // 4 * 4, dtype=np.uint8)
    base = torch.from_numpy(raw.view(np.int32).copy()).to(dev)
    assert base.data_ptr() % 16 == 0
    for off in range(4):
        words = base[off:]
        kernels.reset_launch_counts()
        got = cuda_crc.crc32_words(words, n)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["crc32_words"] == 1
        assert int(got) & 0xFFFFFFFF == zlib.crc32(raw[4 * off : 4 * off + n].tobytes()), off
        assert torch.equal(got, cuda_crc.crc32_words_plain(words, n)), off


def _decompress_capturing_crc(dev, blob, monkeypatch):
    """Decompress ``blob`` on the card; return (bytes, the (words, n_bytes)
    each K11 call was given, the CRC counts, the zlib lengths)."""
    seen = []
    real = bf.crc32_words

    def recording(words, n_bytes):
        seen.append((words, n_bytes))
        return real(words, n_bytes)

    monkeypatch.setattr(bf, "crc32_words", recording)
    lengths = _recording_zlib(monkeypatch)
    out = []
    counts = _crc_counts(lambda: out.append(huffman_tpu_torch.decompress(blob, dev)))
    return out[0], seen, counts, lengths


@pytest.mark.parametrize("case", ["v2, 32 MiB", "v2, odd size", "v1, odd size"])
def test_decompress_takes_the_crc_on_the_card(dev, case, monkeypatch):
    """A verified decompress on the card takes its CRC32 from K11 over the
    decoded output's first original_size bytes, the odd last byte put in
    place on the card (the pad blocks' symbols left out), equal to the
    plain version and to zlib; zlib on the host reads nothing: the main
    path's 32 MiB, an odd size, and the v1 route."""
    from huffman_tpu_torch.corpus import silesia_like as port_silesia_like

    size, mode = {"v2, 32 MiB": (32 << 20, "interleaved"), "v2, odd size": ((3 << 20) + 777, "interleaved"),
                  "v1, odd size": ((3 << 20) + 777, "blocks")}[case]
    data = port_silesia_like(size & ~1, seed=13).tobytes() + (b"\x5a" if size & 1 else b"")
    blob = huffman_tpu_torch.compress(data, dev, mode=mode)
    out, seen, counts, lengths = _decompress_capturing_crc(dev, blob, monkeypatch)
    assert out == data
    assert counts == {"crc_device": 1, "crc_host": 0}
    assert lengths == []
    (words, n_bytes), = seen
    assert n_bytes == size <= 4 * words.numel()
    got = cuda_crc.crc32_words(words, n_bytes)
    assert torch.equal(got, cuda_crc.crc32_words_plain(words, n_bytes))
    assert int(got) & 0xFFFFFFFF == zlib.crc32(data) == bf.ParsedContainer(blob).crc32


def test_unverified_decompress_launches_no_crc(dev, monkeypatch):
    """``verify_crc=False`` launches no K11 and counts neither route."""
    from huffman_tpu_torch.corpus import silesia_like as port_silesia_like

    data = port_silesia_like(1 << 20, seed=2).tobytes()
    blob = huffman_tpu_torch.compress(data, dev)
    lengths = _recording_zlib(monkeypatch)
    kernels.reset_launch_counts()
    out = []
    counts = _crc_counts(lambda: out.append(huffman_tpu_torch.decompress(blob, dev, verify_crc=False)))
    assert out == [data] and counts == {"crc_device": 0, "crc_host": 0} and lengths == []
    launched = kernels.launch_counts()
    assert launched["decode_groups"] == 1 and launched["crc32_words"] == 0


def _root_delta(fn, root: str = "decompress") -> dict:
    before = profiling.counters().get(root, {})
    fn()
    after = profiling.counters().get(root, {})
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def test_resident_256mib_full_alphabet_on_the_card(dev):
    """A 256 MiB container of 65,536 pairs, the benchmark's resident cell:
    compressed on the card (the fused route at 256 groups), held on the
    card, decoded by K1 with its 65,536-symbol table at 256 groups: equal
    to the input and to ``decompress(bytes)``, and held at about its own
    size."""
    from codec_bench import gen

    content = {"kind": "zipf_pairs", "n_unique": 65536, "zipf": 0.65, "base_seed": 11,
               "shuffle_bytes": 1 << 20}
    want = gen.make(content, 256 << 20, 2**31 + 5, 0, dev)
    data = want.cpu().numpy().tobytes()
    blob = huffman_tpu_torch.compress(data, dev)
    h = huffman_tpu_torch.ResidentContainer(blob, dev)
    assert h.raw is None and h.ngroups == 256 and h.tables.sym_order.numel() == 65536
    assert len(blob) <= h.nbytes <= 1.01 * len(data)
    got = []
    counts = _root_delta(lambda: got.append(huffman_tpu_torch.decompress(h)))
    out, = got
    assert out.is_cuda and out.dtype == torch.uint8 and out.shape == (256 << 20,)
    assert torch.equal(out, want)
    assert counts["crc_device"] == 1 and counts["resident_calls"] == 1
    del out, got
    assert huffman_tpu_torch.decompress(blob, dev) == data


def test_resident_call_launches_k1_and_k11_and_copies_no_data(dev):
    """Each resident call launches K1 once and K11 once (its two
    kernels), brings down the CRC's 4 bytes into pinned memory and
    nothing else: no pageable byte either way, no host-to-card copy."""
    from huffman_tpu_torch.corpus import silesia_like as port_silesia_like

    data = port_silesia_like(4 << 20, seed=21).tobytes() + b"\x07"
    h = huffman_tpu_torch.ResidentContainer(huffman_tpu_torch.compress(data, dev), dev)
    kernels.reset_launch_counts()
    outs = []
    counts = _root_delta(lambda: outs.extend(huffman_tpu_torch.decompress(h) for _ in range(3)))
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"decode_groups": 3, "crc32_words": 3}
    assert counts["calls"] == counts["resident_calls"] == counts["crc_device"] == 3
    assert counts["bytes_out"] == 3 * len(data) and counts["host_enqueue_ns"] > 0
    assert "h2d_pageable_bytes" not in counts and "d2h_pageable_bytes" not in counts
    assert all(o.cpu().numpy().tobytes() == data for o in outs)
    for attempt in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            huffman_tpu_torch.decompress(h)
            torch.cuda.synchronize()
        device = {e.key: e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA")}
        if device:
            break
        # A session that saw no device event at all, though K1 and K11 ran
        # (the launch counts above), is the profiler's: CUPTI has missed a
        # whole session late in a long run of these tests. Once more.
        warnings.warn("the profiler recorded no device event; profiling the call again")
    for kernel in ("decode_groups_kernel", "crc32_tiles_kernel", "crc32_combine_kernel"):
        assert sum(n for k, n in device.items() if kernel in k) == 1, device
    copies = {k: n for k, n in device.items() if "Memcpy" in k}
    assert list(copies.values()) == [1] and "DtoH" in next(iter(copies)), device


def test_resident_corrupt_payload_fails_crc_on_the_card(dev):
    """A held container with one flipped payload bit fails the check K11
    takes on the card, with the text of ``decompress(bytes)``."""
    from huffman_tpu_torch.corpus import silesia_like as port_silesia_like

    data = port_silesia_like(4 << 20, seed=9).tobytes() + b"\x03"
    blob = bytearray(huffman_tpu_torch.compress(data, dev))
    blob[len(blob) // 2] ^= 0x10  # a payload bit
    h = huffman_tpu_torch.ResidentContainer(bytes(blob), dev)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="^CRC mismatch: corrupt container or decode bug$"):
        huffman_tpu_torch.decompress(h)
    assert kernels.launch_counts()["crc32_words"] == 1
    with pytest.raises(ValueError, match="^CRC mismatch: corrupt container or decode bug$"):
        huffman_tpu_torch.decompress(bytes(blob), dev)
    out = huffman_tpu_torch.decompress(h, verify_crc=False)
    assert out.is_cuda and out.numel() == len(data)


def test_cli_on_the_card_equals_the_cpu(dev, tmp_path, monkeypatch, capsys):
    from huffman_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.bin").write_bytes(silesia_like(5 << 20, seed=3).tobytes())
    steps = [["compress", "s.bin", "-o", "{d}.htpu"], ["compress", "s.bin", "-o", "{d}.htpx", "--shards", "3"],
             ["compress", "s.bin", "-o", "{d}.htps", "--stream-mb", "2"],
             ["archive", "s.bin", "-o", "{d}.compressed"],
             ["decompress", "{d}.htps", "-o", "{d}.out"], ["verify", "{d}.htpx"],
             ["transcode", "{d}.compressed", "-o", "{d}.t.htpu"]]
    outs = {}
    for device in ("cpu", "cuda"):
        for argv in steps:
            assert cli.main([a.format(d=device) for a in argv] + ["--device", device]) == 0, argv
        outs[device] = capsys.readouterr().out.replace(device, "D")
    assert outs["cuda"] == outs["cpu"]
    for ext in ("htpu", "htpx", "htps", "compressed", "out", "t.htpu"):
        assert (tmp_path / f"cuda.{ext}").read_bytes() == (tmp_path / f"cpu.{ext}").read_bytes(), ext
    assert (tmp_path / "cuda.out").read_bytes() == (tmp_path / "s.bin").read_bytes()


@pytest.fixture(scope="module")
def nccl_world():
    """A world-size-1 NCCL process group on the card (the machine has one),
    and a gloo group over the same rank."""
    import socket

    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def test_distribution_at_world_size_1_equals_single_device(nccl_world):
    """Every function of parallel/pipeline.py over NCCL equals the
    single-device functions on the same tensors; a gloo group refuses
    CUDA tensors and NCCL CPU ones."""
    from huffman_tpu_torch.parallel import pipeline as pp

    dev = torch.device("cuda")
    for data, n_unique in ((silesia_like(4 << 20, seed=7), None),
                           (zipf_pairs(4 << 20, 65536, np.random.default_rng(11)), 65536)):
        raw = torch.from_numpy(data.view(np.int16).copy()).to(dev)
        n_pairs = raw.numel() - 7
        sym = raw.reshape(-1, 512)
        hist = pp.distributed_histogram(sym.reshape(-1)[:n_pairs])
        assert torch.equal(hist, cuda_hist.histogram(sym, n_pairs))
        streams, counts, lengths, ok = pp.distributed_encode_streams(sym, n_pairs)
        r = fused.encode_device(sym, n_pairs, 18)
        assert bool(ok) and torch.equal(lengths, r["lengths"])
        assert torch.equal(counts, r["counts"].to(torch.int32)) and torch.equal(streams, r["streams"])
        if n_unique:
            assert int((lengths > 0).sum()) == n_unique

        cb = bf.Codebook.from_lengths(lengths.cpu().numpy().astype(np.uint8))
        t = tables_from_codebook(cb, dev)
        n_real = torch.tensor([GROUP_LANES] * (sym.shape[0] // GROUP_LANES), dtype=torch.int32, device=dev)
        got = pp.distributed_decode_groups(streams, n_real, t, 512, translate=False)
        want = cuda_gather.gather_u16_pairs(cuda_decode.decode_groups(streams, n_real, t, 512, False),
                                            t.sym_order)
        assert torch.equal(got, want)
        unpacked = pp.distributed_decode_groups(streams, n_real, t, 512, False, packed_out=False)
        assert torch.equal(unpacked, cuda_decode.decode_groups(streams, n_real, t, 512, False, False))

        small = sym[:512]
        n_small = small.numel() - 5
        slab, bits = pp.distributed_encode(small, n_small, t, 512)
        codes, lens = cuda_gather.gather_table_codes(small, t, n_small)
        assert torch.equal(slab, cuda_encode.pack_blocks(codes, lens, 512))
        assert torch.equal(bits, lens.sum(dim=1, dtype=torch.int32))
        out = pp.distributed_decode(slab, t, 512)
        valid = torch.arange(small.numel(), device=dev).reshape(small.shape) < n_small
        assert torch.equal(out[valid], (small.to(torch.int32) & 0xFFFF)[valid])
        h, slab2, bits2, ok2 = pp.compress_decompress_step(small, n_small, t, 512)
        assert int(ok2) == 1 and torch.equal(slab2, slab) and torch.equal(bits2, bits)
        assert torch.equal(h, cuda_hist.histogram(small, n_small))

    with pytest.raises(ValueError, match="cannot take"):
        pp.distributed_histogram(sym.reshape(-1), group=nccl_world)
    with pytest.raises(ValueError, match="cannot take"):
        pp.distributed_histogram(sym.reshape(-1).cpu())
