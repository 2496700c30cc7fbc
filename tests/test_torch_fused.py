"""The port's fused device encode against the JAX package: the histogram
(K6), rank-select (K8) and canonical-rank (K9) plain versions against the
Pallas kernels in interpret mode, the fused encode against
``encode_device_bytes``, and fused-route containers against the host
route and ``huffman_tpu.compress(backend="numpy")``, one input per
alphabet tier. Exact equality throughout."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.container import block_format as jbf
from huffman_tpu.ops import pallas_gather as jpg
from huffman_tpu.codebook import Codebook as JaxCodebook
from huffman_tpu.codebook import package_merge_lengths as jax_package_merge_lengths
from huffman_tpu.ops.fused import encode_device as jax_encode_device
from huffman_tpu.ops.fused import encode_device_bytes as jax_encode_device_bytes
from huffman_tpu.ops.fused import roundtrip_device as jax_roundtrip_device
from huffman_tpu.ops.pallas_hist import histogram_pallas
from huffman_tpu_torch.codebook import Codebook, package_merge_lengths
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.corpus import fibonacci_pairs, zipf_pairs
from huffman_tpu_torch.ops import fused
from huffman_tpu_torch.ops.cuda_gather import (
    build_rank_select,
    gather_rank_canonical,
    gather_rank_select,
)
from huffman_tpu_torch.ops.cuda_hist import histogram
from huffman_tpu_torch.ops.device_codebook import device_canonical_tables

CPU = torch.device("cpu")


def _u16(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint16).view(np.int16))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("n,n_valid", [(4096, 4096), (4095, 4095), (4096, 3001), (1, 1), (4096, 0)])
def test_histogram_matches_pallas(n, n_valid):
    rng = np.random.default_rng(n + n_valid)
    sym = np.concatenate([rng.integers(0, 65536, n // 2), rng.integers(0, 40, n - n // 2)])
    want = np.asarray(histogram_pallas(
        jnp.asarray(sym[:n_valid].astype(np.int32)), interpret=True, cell=4096
    ))
    got = histogram(_u16(sym), n_valid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _hist_mirror(sym, n_valid, offset, ctas=2, clusters=1, threads=1024, unroll=4, single_read=False):
    """csrc/hist.cu's partition of the work, in numpy: ``sym`` starts
    ``offset`` symbols past a 16-byte boundary; symbols up to the next
    boundary (the head) and after the last whole 8-symbol vector (the
    tail) are counted one by one by the first reader's threads 0-15; the
    vectors go to the readers' threads by a grid stride, kUnroll at a time
    and then one by one; a symbol counts in the bins of the cluster block
    whose rank is its top bits: every block of a cluster reads the
    cluster's vectors and counts only its own bins (with ``single_read``,
    the kernel's measured alternative, each block reads its own vectors
    and counts a peer's symbols in the peer's bins). Returns (histogram
    from the blocks' flushes, times each symbol was counted)."""
    cta_bins = 65536 // ctas
    grid = clusters * ctas
    lead = min((16 - 2 * offset % 16) % 16 // 2, n_valid)
    n_vec = (n_valid - lead) // 8
    readers = grid if single_read else clusters
    stride = readers * threads
    bins = np.zeros((grid, cta_bins), np.int64)
    counted = np.zeros(n_valid, np.int64)

    def count(block, pos):
        s = sym[pos].astype(np.int64)
        owner = s // cta_bins
        mine = np.ones(len(pos), bool) if single_read else owner == block % ctas
        np.add.at(bins, (block - block % ctas + owner[mine], s[mine] % cta_bins), 1)
        np.add.at(counted, pos[mine], 1)

    for block in range(grid):
        reader = block if single_read else block // ctas
        for t in range(threads):
            i, vecs = reader * threads + t, []
            while i + (unroll - 1) * stride < n_vec:
                vecs += [i + u * stride for u in range(unroll)]
                i += unroll * stride
            while i < n_vec:
                vecs.append(i)
                i += stride
            pos = lead + 8 * np.repeat(np.array(vecs, np.int64), 8) + np.tile(np.arange(8), len(vecs))
            if reader == 0 and t < 16:
                k = t if t < 8 else lead + 8 * n_vec + t - 8
                if k < (lead if t < 8 else n_valid):
                    pos = np.append(pos, k)
            count(block, pos)
    hist = np.zeros(65536, np.int64)
    for block in range(grid):
        rank = block % ctas
        hist[rank * cta_bins:(rank + 1) * cta_bins] += bins[block]
    return hist, counted


@pytest.mark.parametrize("n_valid,offset,ctas,clusters,threads,single_read", [
    (4096, 0, 2, 1, 1024, False),  # the kernel's block size, aligned
    (4999, 3, 2, 3, 16, False),    # n_valid % 8 == 7, unaligned head, three clusters
    (4001, 7, 4, 2, 16, False),    # four blocks a cluster, n_valid % 8 == 1
    (3003, 1, 2, 2, 32, False),    # n_valid % 8 == 3
    (3003, 1, 2, 2, 32, True),     # each block reads its own share once
    (5, 1, 2, 1, 1024, False),     # fewer symbols than the head
])
def test_histogram_kernel_partition(n_valid, offset, ctas, clusters, threads, single_read):
    """Every symbol counted once, in the bins of the block that owns it, and
    the blocks' flushes against the plain version and histogram_pallas in
    interpret mode."""
    rng = np.random.default_rng(n_valid + offset)
    n = n_valid + offset + 3
    sym = np.concatenate([rng.integers(0, 65536, n // 2), rng.integers(0, 40, n - n // 2)]).astype(np.uint16)
    view = sym[offset:]
    hist, counted = _hist_mirror(view, n_valid, offset, ctas, clusters, threads, single_read=single_read)
    assert (counted == 1).all()
    np.testing.assert_array_equal(hist, histogram(_u16(view), n_valid).numpy())
    want = np.asarray(histogram_pallas(jnp.asarray(view[:n_valid].astype(np.int32)), interpret=True, cell=4096))
    np.testing.assert_array_equal(hist, want)


def _codebook(n_unique, max_len=18, seed=0):
    rng = np.random.default_rng(seed)
    freqs = np.zeros(65536, np.int64)
    freqs[rng.choice(65536, n_unique, replace=False)] = rng.integers(1, 500, n_unique)
    cb = Codebook.from_lengths(package_merge_lengths(freqs, max_len))
    return cb, rng.choice(cb.sym_order, 2048).astype(np.uint16)


@pytest.mark.parametrize("n_unique,cap", [(1, 4096), (3000, 4096), (4096, 4096)])
def test_rank_select_matches_pallas(n_unique, cap):
    cb, sym = _codebook(n_unique, seed=n_unique)
    packed = (cb.lengths.astype(np.uint32) << 26) | cb.codes
    present = cb.lengths > 0
    jm, jc, jd, ok = jpg.build_rank_select(jnp.asarray(packed), jnp.asarray(present), cap=cap)
    m, c, d = build_rank_select(_i32(packed), torch.from_numpy(present), cap)
    for got, want in ((m, jm), (c, jc), (d, jd)):
        np.testing.assert_array_equal(got.numpy().view(np.asarray(want).dtype), np.asarray(want))
    want = np.asarray(jpg.gather_rank_select(
        jnp.asarray(sym.astype(np.int32)), jm, jc, jd, interpret=True, per_cell=1
    ))
    n_valid = 2000
    codes, lens = gather_rank_select(_u16(sym), n_valid, m, c, d)
    valid = np.arange(sym.size) < n_valid
    np.testing.assert_array_equal(codes.numpy().view(np.uint32), np.where(valid, want & ((1 << 26) - 1), 0))
    np.testing.assert_array_equal(lens.numpy(), np.where(valid, want >> 26, 0))
    np.testing.assert_array_equal(lens.numpy()[:n_valid], cb.lengths[sym[:n_valid]])


@pytest.mark.parametrize("n_unique,cap,max_len", [(9000, 16384, 18), (16384, 16384, 26),
                                                  (20000, 32768, 18), (40000, 65536, 18),
                                                  (65536, 65536, 16)])
def test_rank_canonical_matches_pallas(n_unique, cap, max_len):
    cb, sym = _codebook(n_unique, max_len, seed=n_unique)
    t = device_canonical_tables(torch.from_numpy(cb.lengths.astype(np.int32)))
    present = torch.from_numpy(cb.lengths > 0)
    identity = cap == 65536
    if identity:
        ranks = t.sym_rank.to(torch.int64)
        m = c = torch.zeros(2048, dtype=torch.int32)
    else:
        m, c, d = build_rank_select(t.sym_rank, present, cap)
        ranks = d.to(torch.int64) & 0xFFFFFFFF
    canon16 = (ranks[0::2] | (ranks[1::2] << 16)).numpy().astype(np.uint32)
    want = np.asarray(jpg.gather_rank_canonical(
        jnp.asarray(sym.astype(np.int32)), jnp.asarray(m.numpy().view(np.uint32)),
        jnp.asarray(c.numpy()), jnp.asarray(canon16), jnp.asarray(t.start.numpy()),
        jnp.asarray(t.base.numpy().view(np.uint32)), max_len=max_len,
        interpret=True, identity_rank=identity, per_cell=1,
    ))
    codes, lens = gather_rank_canonical(
        _u16(sym), sym.size, m, c, _i32(canon16), t.start, t.base, max_len, identity
    )
    np.testing.assert_array_equal(codes.numpy().view(np.uint32), want & ((1 << 26) - 1))
    np.testing.assert_array_equal(lens.numpy(), want >> 26)
    np.testing.assert_array_equal(codes.numpy().view(np.uint32), cb.codes[sym])
    np.testing.assert_array_equal(lens.numpy(), cb.lengths[sym])


def _canon_lengths(max_len, n_unique=None, seed=0):
    """(65536,) code lengths at most ``max_len``: one symbol of length 1
    for max_len 1; by default three codes at each even length below
    ``max_len - 1`` and four at ``max_len`` (every odd length an empty
    class, equal consecutive start entries); else package-merge lengths
    of ``n_unique`` random frequencies."""
    rng = np.random.default_rng(seed)
    lengths = np.zeros(65536, np.int64)
    if max_len == 1:
        lengths[rng.integers(65536)] = 1
    elif n_unique is None:
        ls = [l for l in range(2, max_len - 1, 2) for _ in range(3)] + [max_len] * 4
        lengths[rng.choice(65536, len(ls), replace=False)] = ls
    else:
        freqs = np.zeros(65536, np.int64)
        freqs[rng.choice(65536, n_unique, replace=False)] = rng.integers(1, 500, n_unique)
        lengths = package_merge_lengths(freqs, max_len).astype(np.int64)
    assert lengths.max() <= max_len and (2.0 ** -lengths[lengths > 0]).sum() <= 1
    return lengths


def _canon_tables(lengths, identity, cap=16384):
    """K9's arguments after the symbols, as fused.tiered_code_gather builds
    them: (maskwords, cums, canon16, start, base)."""
    t = device_canonical_tables(torch.from_numpy(lengths.astype(np.int32)))
    if identity:
        ranks = t.sym_rank.to(torch.int64)
        m = c = torch.zeros(2048, dtype=torch.int32)
    else:
        m, c, d = build_rank_select(t.sym_rank, torch.from_numpy(lengths > 0), cap)
        ranks = d.to(torch.int64) & 0xFFFFFFFF
    canon16 = _i32((ranks[0::2] | (ranks[1::2] << 16)).numpy())
    return m, c, canon16, t.start, t.base


def _k9_length(canon, start, max_len):
    """csrc/rank_gather.cu's length search: lane j holds start[j + 2]
    (INT32_MAX past max_len); five halving steps count the boundaries at
    or below canon."""
    lane = np.arange(32)
    bound = np.where(lane + 2 <= max_len, np.asarray(start)[np.minimum(lane + 2, 32)], 2**31 - 1)
    pos = np.zeros(canon.shape, np.int64)
    for step in (16, 8, 4, 2, 1):
        pos = np.where(canon >= bound[pos + step - 1], pos + step, pos)
    return pos + 1


def _k9_canonical(s, m, c, canon16, start, base, max_len, identity):
    """The kernel's len << 26 | code (uint32) of symbols ``s``."""
    s = s.astype(np.int64)
    if identity:
        rank = s
    else:
        mw = m.numpy().view(np.uint32).astype(np.int64)[s >> 5]
        below = (np.int64(1) << (s & 31)) - 1
        rank = c.numpy().astype(np.int64)[s >> 5] + np.bitwise_count(mw & below)
    table = canon16.numpy().view(np.uint32).astype(np.int64)
    pair = table[np.clip(rank >> 1, 0, table.size - 1)]
    canon = (pair >> ((rank & 1) << 4)) & 0xFFFF
    length = _k9_length(canon, start.numpy(), max_len)
    code = (canon - base.numpy().view(np.uint32).astype(np.int64)[length]) & 0xFFFFFFFF
    return ((length << 26) | code) & 0xFFFFFFFF


def _k9_load4(words, offset, k):
    """load4 of vector k (symbols 4k .. 4k + 3) of a view ``offset`` u16
    past a 16-byte aligned buffer whose 32-bit words are ``words``: one
    8-byte load at phase 0, else two or three 4-byte loads and a funnel
    shift. Returns the four u16 symbols."""
    addr = 2 * (offset + 4 * k)
    phase, w = addr % 8, addr // 4
    if phase == 0 or phase % 4 == 0:
        x, y = int(words[w]), int(words[w + 1])
    else:
        a, b, c = (int(v) for v in words[w:w + 3])
        x, y = ((b << 32 | a) >> 16) & 0xFFFFFFFF, ((c << 32 | b) >> 16) & 0xFFFFFFFF
    return [x & 0xFFFF, x >> 16, y & 0xFFFF, y >> 16]


def _k9_mirror(words, offset, n, n_valid, tables, max_len, identity, threads, grid, vecs=8):
    """csrc/rank_gather.cu's K9 walk in numpy: thread t takes the vectors
    t + (j * vecs + u) * stride of step j while its warp's first is below
    n_vec = n // 4 (the last step's lanes past n_vec load a clamped vector
    and store nothing), then the n % 4 tail one symbol a thread. Returns
    (packed output, times each position was written, symbols as loaded)."""
    n_vec, stride = n // 4, grid * threads
    out = np.zeros(n, np.int64)
    written = np.zeros(n, np.int64)
    loaded = np.full(n, -1, np.int64)
    for t in range(stride):
        warp_first = t - t % 32
        j = 0
        while warp_first + j * vecs * stride < n_vec:
            for u in range(vecs):
                k = t + (j * vecs + u) * stride
                syms = _k9_load4(words, offset, min(k, n_vec - 1))
                if k < n_vec:
                    packed = _k9_canonical(np.array(syms), *tables, max_len, identity)
                    valid = max(min(n_valid - 4 * k, 4), 0)
                    packed[valid:] = 0
                    out[4 * k:4 * k + 4] = packed
                    written[4 * k:4 * k + 4] += 1
                    loaded[4 * k:4 * k + 4] = syms
            j += 1
        i = 4 * n_vec + t
        while i - t % 32 < n:
            if i < n:
                sym = int(words[(2 * (offset + i)) // 4]) >> (16 * ((offset + i) % 2)) & 0xFFFF
                out[i] = _k9_canonical(np.array([sym]), *tables, max_len, identity)[0] if i < n_valid else 0
                written[i] += 1
                loaded[i] = sym
            i += stride
    return out, written, loaded


@pytest.mark.parametrize("offset,n,n_valid,threads,grid,identity", [
    (0, 4003, 4003, 32, 1, False),   # aligned view, n % 4 == 3, four steps a thread
    (1, 2002, 1999, 64, 3, True),    # three 4-byte loads a vector, n_valid % 4 == 3
    (2, 2001, 1000, 32, 1, False),   # two 4-byte loads, two steps a thread
    (3, 2000, 2000, 32, 3, True),    # three loads, whole vectors only
    (4, 1997, 1997, 64, 2, False),   # 8-byte loads past an 8-byte boundary
    (5, 3, 3, 64, 1, False),         # the tail alone
    (6, 2005, 0, 32, 2, True),       # n_valid 0
    (7, 1000, 4, 96, 1, False),      # fewer vectors than threads
])
def test_rank_canonical_kernel_split(offset, n, n_valid, threads, grid, identity):
    """The kernel's walk writes every position once, loads each symbol
    right at any 2-byte offset of the view, and equals the plain version
    and the JAX function in interpret mode, absent symbols included."""
    rng = np.random.default_rng(offset)
    lengths = _canon_lengths(18, n_unique=3000, seed=offset)
    present = np.flatnonzero(lengths)
    buf = rng.choice(present, -(-(offset + n) // 8) * 8 + 8).astype(np.uint16)
    buf[offset + rng.choice(n, n // 5)] = rng.integers(0, 65536, n // 5)  # absent symbols too
    view = buf[offset:offset + n]
    words = np.frombuffer(buf.tobytes(), "<u4")
    tables = _canon_tables(lengths, identity)
    got, written, loaded = _k9_mirror(words, offset, n, n_valid, tables, 18, identity, threads, grid)
    assert (written == 1).all()
    np.testing.assert_array_equal(loaded, view)
    codes, lens = gather_rank_canonical(_u16(view), n_valid, *tables, 18, identity)
    np.testing.assert_array_equal(got & ((1 << 26) - 1), codes.numpy().view(np.uint32))
    np.testing.assert_array_equal(got >> 26, lens.numpy())
    m, c, canon16, start, base = tables
    want = np.asarray(jpg.gather_rank_canonical(
        jnp.asarray(view.astype(np.int32)), jnp.asarray(m.numpy().view(np.uint32)), jnp.asarray(c.numpy()),
        jnp.asarray(canon16.numpy().view(np.uint32)), jnp.asarray(start.numpy()),
        jnp.asarray(base.numpy().view(np.uint32)), max_len=18, interpret=True, identity_rank=identity,
        per_cell=1,
    )).astype(np.int64)
    np.testing.assert_array_equal(got, np.where(np.arange(n) < n_valid, want, 0))


@pytest.mark.parametrize("max_len,n_unique,identity", [
    (1, None, False), (1, None, True), (2, None, False), (18, None, True),
    (18, 4000, False), (26, None, False), (26, None, True), (26, 16000, True),
])
def test_rank_canonical_length_search(max_len, n_unique, identity):
    """The kernel's register binary search for the length, and its code,
    against the plain version on every one of the 65,536 symbols (the
    absent ones too) and against the JAX function in interpret mode on the
    present symbols and 2,048 absent ones, with empty length classes."""
    lengths = _canon_lengths(max_len, n_unique, seed=max_len)
    tables = _canon_tables(lengths, identity)
    sym = np.arange(65536, dtype=np.uint16)
    got = _k9_canonical(sym, *tables, max_len, identity)
    codes, lens = gather_rank_canonical(_u16(sym), sym.size, *tables, max_len, identity)
    np.testing.assert_array_equal(got & ((1 << 26) - 1), codes.numpy().view(np.uint32))
    np.testing.assert_array_equal(got >> 26, lens.numpy())
    present = lengths > 0
    np.testing.assert_array_equal((got >> 26)[present], lengths[present])
    absent = np.random.default_rng(max_len).choice(np.flatnonzero(~present), 2048, replace=False)
    some = np.concatenate([np.flatnonzero(present), absent])
    m, c, canon16, start, base = tables
    want = np.asarray(jpg.gather_rank_canonical(
        jnp.asarray(some.astype(np.int32)), jnp.asarray(m.numpy().view(np.uint32)), jnp.asarray(c.numpy()),
        jnp.asarray(canon16.numpy().view(np.uint32)), jnp.asarray(start.numpy()),
        jnp.asarray(base.numpy().view(np.uint32)), max_len=max_len, interpret=True, identity_rank=identity,
        per_cell=1,
    )).astype(np.int64)
    np.testing.assert_array_equal(got[some], want)


@pytest.mark.parametrize("nalpha", [100, 256, 257, 1024])
def test_fused_encode_matches_jax_encode_device_bytes(nalpha):
    """Streams, counts and lengths of the whole fused encode. The JAX side
    runs a small explicit ladder (256, then a 1024 cap) and the port its
    4096 tier: package-merge lengths, and so the streams, do not depend on
    the cap."""
    B, n_pairs = 4, 4000
    rng = np.random.default_rng(nalpha)
    alpha = rng.choice(65536, nalpha, replace=False)
    sym = np.concatenate([alpha, rng.choice(alpha, n_pairs - nalpha)]).astype("<u2")
    padded = np.zeros(1024 * B * 2, np.uint8)
    padded[: 2 * n_pairs] = sym.view(np.uint8)
    r = jax_encode_device_bytes(
        jnp.asarray(padded), jnp.int32(n_pairs), B, max_len=18, interpret=True,
        gather="displacement", tiers=(256,), alphabet_cap=1024,
    )
    assert bool(r["ok"])
    ours = fused.encode_device_bytes(torch.from_numpy(padded), n_pairs, B, 18)
    counts = np.asarray(r["counts"])
    np.testing.assert_array_equal(ours["counts"].numpy(), counts)
    np.testing.assert_array_equal(ours["lengths"].numpy(), np.asarray(r["lengths"]))
    np.testing.assert_array_equal(ours["hist"].numpy(), np.asarray(r["hist"]))
    want_s = np.asarray(r["streams"])
    got_s = ours["streams"].numpy().view(np.uint32)
    for g, n in enumerate(counts):
        np.testing.assert_array_equal(got_s[g, :n], want_s[g, :n])


def _tier_input(n_unique, seed):
    """Compressible input whose alphabet lands in the tier of n_unique:
    every symbol once, then a skewed draw."""
    rng = np.random.default_rng(seed)
    alpha = rng.choice(65536, n_unique, replace=False).astype(np.uint16)
    p = 1.0 / np.arange(1, n_unique + 1) ** 1.3
    body = rng.choice(alpha, 120_000, p=p / p.sum())
    return np.concatenate([alpha, body]).astype("<u2").tobytes() + b"\x07"


@pytest.mark.parametrize("n_unique,tier", [(1000, 4096), (10000, 16384),
                                           (20000, 32768), (40000, 65536)])
def test_fused_container_matches_host_routes(n_unique, tier, monkeypatch):
    data = _tier_input(n_unique, n_unique)
    B, n_pairs = 64, len(data) // 2
    nblocks = -(-n_pairs // B)
    out, cb = bf._compress_v2_fused(data, n_pairs, True, data[-1], B, nblocks, 18, CPU)
    assert cb.n_unique == n_unique and fused.tier_for(n_unique) == tier
    symbols = np.frombuffer(data[: 2 * n_pairs], "<u2")
    want, _ = jbf._compress_host_codebook(
        data, symbols, True, data[-1], None, B, nblocks, "numpy", "interleaved", True, 18
    )
    assert out == want
    host, _ = bf._compress_host_codebook(
        data, True, data[-1], None, B, nblocks, 18, CPU, "interleaved", True
    )
    assert out == host

    # Through the public entry point, with the fused route's size threshold
    # lowered to this input.
    monkeypatch.setattr(bf, "DEVICE_MIN_PAIRS", n_pairs)
    blob = huffman_tpu_torch.compress(data, "cpu", block_symbols=B)
    assert blob == huffman_tpu.compress(data, backend="numpy", block_symbols=B)
    assert huffman_tpu_torch.decompress(blob, "cpu") == data
    assert huffman_tpu.decompress(blob) == data


def test_route_selection(monkeypatch):
    calls = []
    real = bf._compress_v2_fused
    monkeypatch.setattr(bf, "_compress_v2_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    data = zipf_pairs(40_000, 300, np.random.default_rng(2)).tobytes()
    huffman_tpu_torch.compress(data, "cpu")
    assert not calls  # below DEVICE_MIN_PAIRS: host route
    monkeypatch.setattr(bf, "DEVICE_MIN_PAIRS", 1000)
    for kwargs in ({"max_code_len": 15}, {"max_code_len": 27}, {"max_code_len": None},
                   {"codebook": Codebook.from_frequencies(np.bincount(
                       np.frombuffer(data, "<u2"), minlength=65536))}):
        blob = huffman_tpu_torch.compress(data, "cpu", **kwargs)
        assert huffman_tpu_torch.decompress(blob, "cpu") == data
    assert not calls  # the host route for each of those
    blob = huffman_tpu_torch.compress(data, "cpu", max_code_len=16)
    assert calls == [1]
    assert blob == huffman_tpu.compress(data, backend="numpy", max_code_len=16)


def test_fused_encode_rejects_an_infeasible_limit():
    sym = torch.arange(1024 * 4, dtype=torch.int32).to(torch.int16).reshape(1024, 4)
    with pytest.raises(ValueError, match="cannot encode"):
        fused.encode_device(sym, 4096, max_len=10)


def _lanes(sym: np.ndarray, B: int) -> np.ndarray:
    """u16 symbols zero-padded to whole groups of B-symbol lanes."""
    n_lanes = -(-sym.size // (B * 1024)) * 1024
    out = np.zeros(n_lanes * B, np.uint16)
    out[: sym.size] = sym
    return out


@pytest.mark.parametrize("n_unique", [4095, 4096, 4097, 16384, 16385])
@pytest.mark.parametrize("form", ["route", "K8", "K9"])
def test_tiered_code_gather_at_the_gather_boundary(n_unique, form, monkeypatch):
    """``tiered_code_gather`` below, at and past the tier caps on either
    side of ``CANON_GATHER_MIN_CAP`` (n_unique equal to a tier included),
    through the gather the constant picks and through each gather forced:
    the lengths, codes and code lengths equal the JAX package's codebook
    (package-merge of the same histogram) at every valid position, 0
    past ``n_valid``."""
    rng = np.random.default_rng(n_unique)
    alpha = rng.choice(65536, n_unique, replace=False)
    p = 1.0 / np.arange(1, n_unique + 1) ** 0.9
    sym = np.concatenate([alpha, rng.choice(alpha, 2 * n_unique, p=p / p.sum())]).astype(np.uint16)
    rng.shuffle(sym)
    B, n_valid = 8, sym.size
    padded = _lanes(sym, B)
    t = _u16(padded).reshape(-1, B)
    cap = fused.tier_for(n_unique)
    want_form = "K8" if cap < fused.CANON_GATHER_MIN_CAP else "K9"
    if form != "route":
        monkeypatch.setattr(fused, "CANON_GATHER_MIN_CAP", cap + 1 if form == "K8" else 0)
        want_form = form
    ran = []
    for name, tag in (("gather_rank_select", "K8"), ("gather_rank_canonical", "K9")):
        def record(*a, _fn=getattr(fused, name), _tag=tag):
            ran.append(_tag)
            return _fn(*a)

        monkeypatch.setattr(fused, name, record)
    lengths, codes, lens, got_cap = fused.tiered_code_gather(
        histogram(t, n_valid), n_unique, t, n_valid, max_len=18
    )
    assert got_cap == cap and ran == [want_form]
    cb = JaxCodebook.from_lengths(jax_package_merge_lengths(np.bincount(sym, minlength=65536), 18))
    np.testing.assert_array_equal(lengths.numpy(), cb.lengths)
    valid = np.arange(padded.size) < n_valid
    np.testing.assert_array_equal(codes.numpy().reshape(-1).view(np.uint32), np.where(valid, cb.codes[padded], 0))
    np.testing.assert_array_equal(lens.numpy().reshape(-1), np.where(valid, cb.lengths[padded], 0))


@pytest.mark.parametrize("max_len", [27, 28, 29, 30, 31, 32])
def test_encode_device_past_26_bits_matches_jax_xla_tier(max_len):
    """Limits past the rank gathers' 26 bits: package-merge (K7's plain
    version), canonical tables and the two-table gather, against the JAX
    encoder's exact tier (``gather="xla"``)."""
    B = 4
    sym = np.frombuffer(fibonacci_pairs(17, seed=max_len).tobytes(), "<u2")
    padded = _lanes(sym, B)
    r = jax_encode_device(
        jnp.asarray(padded.astype(np.int32)), jnp.int32(sym.size), B, max_len=max_len,
        interpret=True, gather="xla", alphabet_cap=256,
    )
    assert bool(r["ok"])
    ours = fused.encode_device(_u16(padded).reshape(-1, B), sym.size, max_len)
    np.testing.assert_array_equal(ours["lengths"].numpy(), np.asarray(r["lengths"]))
    counts = np.asarray(r["counts"])
    np.testing.assert_array_equal(ours["counts"].numpy(), counts)
    want_s, got_s = np.asarray(r["streams"]), ours["streams"].numpy().view(np.uint32)
    for g, n in enumerate(counts):
        np.testing.assert_array_equal(got_s[g, :n], want_s[g, :n])


@pytest.mark.parametrize("max_len", [27, 28])
def test_encode_device_limit_binds_past_26_bits(max_len):
    """On the 29-bit Fibonacci input the limit binds: the lengths equal
    the JAX package's host package-merge at that limit."""
    B = 512
    data = fibonacci_pairs()
    sym = np.frombuffer(data.tobytes(), "<u2")
    ours = fused.encode_device_bytes(torch.from_numpy(_lanes(sym, B).view(np.uint8)), sym.size, B, max_len)
    want = jax_package_merge_lengths(np.bincount(sym, minlength=65536), max_len)
    assert int(want.max()) == max_len
    np.testing.assert_array_equal(ours["lengths"].numpy(), want)


def test_roundtrip_device_matches_jax():
    B, n_pairs = 64, 30000
    rng = np.random.default_rng(0)
    alpha = rng.choice(65536, 150, replace=False)
    p = 1.0 / np.arange(1, 151) ** 1.1
    sym = rng.choice(alpha, n_pairs, p=p / p.sum()).astype(np.uint16)
    padded = _lanes(sym, B)
    ok, words = fused.roundtrip_device(_u16(padded).reshape(-1, B), n_pairs, 32)
    want_ok, want_words = jax_roundtrip_device(padded.astype(np.int32), np.int32(n_pairs), B, interpret=True)
    assert bool(ok) and bool(want_ok)
    assert int(words) == int(want_words)
