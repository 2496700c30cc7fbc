"""Port codebook construction against the JAX package: the package-merge
kernel's plain version (K7) against the Pallas kernel in interpret mode
and the XLA twin, numpy mirrors of the CUDA kernel's leaf order, merge
positions and level counts (csrc/package_merge.cu) against the plain
version, the device canonical tables against both packages' host
codebooks, and the port's copied host codebook against the JAX
package's. Exact equality throughout (the codec is integer)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import huffman_tpu.codebook as jcb
from huffman_tpu.ops import device_codebook as dc
from huffman_tpu_torch.codebook import (
    Codebook,
    code_lengths_from_frequencies,
    package_merge_lengths,
)
from huffman_tpu_torch.ops.device_codebook import (
    device_canonical_tables,
    device_code_lengths,
    package_merge,
    package_merge_plain,
)

TIERS = (4096, 16384, 32768, 65536)
INF = 1 << 30
BLOCK = 1024  # threads of csrc/package_merge.cu's one-block kernel and count


def _fib(n):
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    return np.array(fib[:n], np.int64)


def _hist(kind, n_sym=65536, seed=0):
    rng = np.random.default_rng(seed)
    f = np.zeros(n_sym, np.int64)
    if kind == "empty":
        return f
    if kind == "one":
        f[rng.integers(n_sym)] = 77
    elif kind == "two":
        f[rng.choice(n_sym, 2, replace=False)] = [5, 5]
    elif kind == "fibonacci":  # forces the length limit at max_len 16
        idx = rng.choice(n_sym, 40, replace=False)
        f[idx] = _fib(40)
    elif kind == "zipf":
        idx = rng.choice(n_sym, 3000, replace=False)
        f[idx] = np.clip(rng.zipf(1.3, 3000), 1, 1 << 20)
    elif kind == "full":
        f[:] = rng.integers(1, 1000, n_sym)
    return f


@pytest.mark.parametrize("n_sym,K,max_len,nal", [(256, 256, 8, 100), (1024, 1024, 6, 40)])
def test_package_merge_plain_matches_pallas_kernel(n_sym, K, max_len, nal):
    rng = np.random.default_rng(K + nal)
    freqs = np.zeros(n_sym, np.int32)
    idx = rng.choice(n_sym, nal, replace=False)
    freqs[idx[:20]] = _fib(20)  # deep optimal tree: the limit binds
    freqs[idx[20:]] = rng.integers(1, 50, nal - 20)  # duplicate weights
    want_len, want_sym = (np.asarray(a) for a in dc._pm_pallas(
        jnp.asarray(freqs), jnp.int32(nal), max_len, K, interpret=True
    ))
    got_len, got_sym = package_merge(torch.from_numpy(freqs), nal, max_len, K)
    np.testing.assert_array_equal(got_sym.numpy(), want_sym)
    np.testing.assert_array_equal(got_len.numpy(), want_len)


# The edge cases at the smallest tier, a skewed histogram at every tier,
# and the full alphabet at the only tier the route gives it.
@pytest.mark.parametrize("kind,max_len,tier", [
    ("empty", 18, 4096), ("one", 18, 4096), ("two", 18, 4096),
    ("fibonacci", 16, 4096), ("zipf", 26, 4096),
] + [("zipf", 18, tier) for tier in TIERS] + [("full", 16, 65536), ("full", 18, 65536)])
def test_device_code_lengths_match_xla_twin(kind, max_len, tier):
    freqs = _hist(kind, seed=tier).astype(np.int32)
    want = np.asarray(dc.device_code_lengths(
        jnp.asarray(freqs), max_len=max_len, alphabet_cap=tier, use_kernel=False,
    ))
    got = device_code_lengths(torch.from_numpy(freqs), max_len, tier, int((freqs > 0).sum()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), package_merge_lengths(freqs, max_len))


# Mirrors of csrc/package_merge.cu: keep them in step with the source.


def _merge_sort(keys):
    """pm_one_block's sort: the keys padded with the largest value to a
    power of two of at least 4; thread t sorts keys [4t, 4t + 4), then
    each pass merges pairs of runs, thread t writing outputs [4t, 4t + 4)
    of its pair after a merge-path search."""
    size = 4
    while size < keys.size:
        size <<= 1
    pad = np.iinfo(np.int64).max
    x = np.full(size, pad, np.int64)
    x[: keys.size] = keys
    x = np.sort(x.reshape(-1, 4), axis=1).ravel()  # the 4-key network
    run = 4
    while run < size:
        out = np.empty_like(x)
        for e0 in range(0, size, 4):
            pair = e0 & ~(2 * run - 1)
            d = e0 - pair
            a, b = x[pair: pair + run], x[pair + run: pair + 2 * run]
            lo, hi = max(d - run, 0), min(d, run)
            while lo < hi:
                mid = (lo + hi) >> 1
                lo, hi = (mid + 1, hi) if a[mid] < b[d - 1 - mid] else (lo, mid)
            i, j = lo, d - lo
            for m in range(4):
                va, vb = (a[i] if i < run else pad), (b[j] if j < run else pad)
                out[e0 + m] = min(va, vb)
                i, j = i + (va < vb), j + (va >= vb)
        x, run = out, run * 2
    return x[: keys.size]


def _one_block_leaves(freqs, K, seed=0):
    """pm_one_block's leaves: the present keys gathered in any order
    (here shuffled) and sorted as the kernel sorts them; ranks n .. K - 1
    are the first absent symbols, by a scan of bins [0, K) in index order.
    Returns (leaf keys, leaf symbols)."""
    s = np.flatnonzero(freqs > 0)
    keys = np.random.default_rng(seed).permutation(freqs[s].astype(np.int64) << 16 | s)[:K]
    keys = _merge_sort(keys)
    n_leaf = keys.size
    absent = np.flatnonzero(freqs[:K] <= 0)
    return (np.concatenate([keys >> 16 << 1, np.full(K - n_leaf, INF << 1)]),
            np.concatenate([keys & 0xFFFF, absent[: K - n_leaf]]))


def _merge_path_runs(leaf, pkg):
    """pm_one_block's round: thread t merges outputs [t * per, (t + 1) *
    per) after a merge-path search. Returns the leaves' positions, each
    run's split (the leaves among the outputs before it) and the mask of
    its leaf outputs, and per."""
    K = leaf.size
    per = max(2 * K // BLOCK, 1)
    d0 = np.arange(0, 2 * K, per)
    lo, hi = np.maximum(d0 - K, 0), np.minimum(d0, K)
    while (lo < hi).any():
        mid = (lo + hi) >> 1
        go = (lo < hi) & (leaf[np.minimum(mid, K - 1)] < pkg[np.clip(d0 - 1 - mid, 0, K - 1)])
        lo, hi = np.where(go, mid + 1, lo), np.where((lo < hi) & ~go, mid, hi)
    i, j = lo, d0 - lo
    splits, mask = lo, np.zeros(d0.size, np.int64)
    pos = np.full(K, -1)
    above = np.iinfo(np.int64).max
    for d in range(per):
        take = (np.where(i < K, leaf[np.minimum(i, K - 1)], above)
                < np.where(j < K, pkg[np.minimum(j, K - 1)], above))
        pos[i[take]] = (d0 + d)[take]
        mask |= take.astype(np.int64) << d
        i, j = i + take, j + ~take
    return pos, splits, mask, per


def _count_below(pos, c):
    """count_below: #{t : pos[t] < c} by probes of BLOCK equal slices."""
    base, n = 0, pos.size
    while True:
        stride = n // BLOCK if n > BLOCK else 1
        probes = n // stride
        below = int((pos[base + np.arange(1, probes + 1) * stride - 1] < c).sum())
        base += below * stride
        if stride == 1 or below == probes:
            return base
        n = stride


@pytest.mark.parametrize("n_sym", [256, 1024, 65536])
def test_one_block_leaves_are_the_first_of_the_full_sort(n_sym):
    K = min(n_sym, 4096)
    rng = np.random.default_rng(n_sym)
    for n in (0, 1, 2, K):
        freqs = np.zeros(n_sym, np.int32)
        freqs[rng.choice(n_sym, n, replace=False)] = rng.integers(1, 8, n)  # ties: the symbol decides
        w = np.where(freqs > 0, freqs, INF).astype(np.int64)
        want = np.sort(w << 16 | np.arange(n_sym))[:K]
        leaf, sym = _one_block_leaves(freqs, K)
        np.testing.assert_array_equal(sym, want & 0xFFFF)
        np.testing.assert_array_equal(leaf, want >> 16 << 1)
        _, plain_sym = package_merge_plain(torch.from_numpy(freqs), n, 18, K)
        np.testing.assert_array_equal(plain_sym.numpy(), sym)


@pytest.mark.parametrize("kind,tier", [("fibonacci", 4096), ("zipf", 4096), ("zipf", 32768)])
@pytest.mark.parametrize("max_len", [16, 18, 32])
def test_level_counts_by_search_over_leaf_positions(kind, tier, max_len):
    """Per round, the leaves' positions by rank (pm_round) and by merge
    path (pm_one_block) agree; per level, the packages among the first c
    items by search over the positions (pm_count) and from the runs'
    splits and leaf masks (pm_one_block) equal the plain version's flag
    sum; the lengths so counted equal the plain version's and the host's."""
    freqs = _hist(kind, seed=tier).astype(np.int32)
    K, n = tier, int((freqs > 0).sum())
    leaf, sym = _one_block_leaves(freqs, K)
    x = np.concatenate([leaf, np.full(K, INF << 1)])
    rounds = []
    for _ in range(max_len - 1):
        a, b = x[0::2] >> 1, x[1::2] >> 1
        pkg = np.where((a >= INF) | (b >= INF), INF, np.minimum(a + b, INF)) << 1 | 1
        pos = np.arange(K) + np.searchsorted(pkg, leaf)
        mp_pos, splits, mask, per = _merge_path_runs(leaf, pkg)
        np.testing.assert_array_equal(mp_pos, pos)
        x = np.empty(2 * K, np.int64)
        x[pos] = leaf
        x[np.arange(K) + np.searchsorted(leaf, pkg)] = pkg
        rounds.append((x & 1, pos, splits, mask, per))
    m_level, c = [0] * max_len, max(2 * n - 2, 0)
    for level in range(max_len - 1, 0, -1):
        flags, pos, splits, mask, per = rounds[level - 1]
        items = min(c, 2 * K)
        p = items - _count_below(pos, items)  # pm_count
        assert p == int(flags[:c].sum())
        if items < 2 * K:  # pm_one_block
            run, within = divmod(items, per)
            assert p == items - splits[run] - bin(int(mask[run]) & ((1 << within) - 1)).count("1")
        m_level[level], c = c - p, 2 * p
    m_level[0] = c
    lengths = (np.arange(K)[:, None] < np.array(m_level)[None, :]).sum(axis=1)
    want_len, want_sym = package_merge_plain(torch.from_numpy(freqs), n, max_len, K)
    np.testing.assert_array_equal(sym, want_sym.numpy())
    np.testing.assert_array_equal(lengths, want_len.numpy())
    dense = np.zeros(freqs.size, np.int64)
    dense[sym] = lengths
    np.testing.assert_array_equal(np.where(freqs > 0, dense, 0), package_merge_lengths(freqs, max_len))


@pytest.mark.parametrize("kind,max_len", [("one", 18), ("two", 18), ("fibonacci", 16),
                                          ("zipf", 26), ("full", 16)])
def test_canonical_tables_match_both_codebooks(kind, max_len):
    freqs = _hist(kind, seed=3)
    lengths = package_merge_lengths(freqs, max_len)
    t = device_canonical_tables(torch.from_numpy(lengths.astype(np.int32)))
    ours, theirs = Codebook.from_lengths(lengths), jcb.Codebook.from_lengths(lengths)
    u32 = lambda x: x.numpy().view(np.uint32)  # noqa: E731
    for cb in (ours, theirs):
        np.testing.assert_array_equal(u32(t.enc_codes), cb.codes)
        np.testing.assert_array_equal(t.enc_lens.numpy(), cb.lengths)
        np.testing.assert_array_equal(u32(t.lj_limit), cb.lj_limit)
        np.testing.assert_array_equal(u32(t.base), cb.base & 0xFFFFFFFF)
        np.testing.assert_array_equal(t.sym_rank.numpy()[cb.sym_order], np.arange(cb.n_unique))
    jax_t = dc.device_canonical_tables(jnp.asarray(lengths.astype(np.int32)))
    for got, want in zip(t[:5], jax_t):
        np.testing.assert_array_equal(got.numpy().view(np.asarray(want).dtype), np.asarray(want))
    counts = np.bincount(lengths, minlength=33)
    counts[0] = 0
    np.testing.assert_array_equal(t.start.numpy(), np.cumsum(counts) - counts)


@pytest.mark.parametrize("kind", ["one", "two", "fibonacci", "zipf", "full"])
@pytest.mark.parametrize("max_len", [16, 26, None])
def test_copied_host_codebook_matches_jax_package(kind, max_len):
    freqs = _hist(kind, seed=11)
    if max_len is None:
        got, want = code_lengths_from_frequencies(freqs), jcb.code_lengths_from_frequencies(freqs)
    else:
        got, want = package_merge_lengths(freqs, max_len), jcb.package_merge_lengths(freqs, max_len)
    np.testing.assert_array_equal(got, want)
    ours, theirs = Codebook.from_lengths(got), jcb.Codebook.from_lengths(want)
    for field in ("lengths", "codes", "sym_order", "lj_limit", "lj_first", "base"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))


def test_jax_codebook_carries_over_by_its_lengths():
    theirs = jcb.Codebook.from_frequencies(_hist("zipf", seed=5))
    ours = Codebook.from_lengths(np.asarray(theirs.lengths))
    for field in ("lengths", "codes", "sym_order", "lj_limit", "lj_first", "base"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))


def test_package_merge_rejects_what_the_kernel_cannot_take():
    freqs = torch.zeros(65536, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        package_merge(freqs, 0, 18, 3000)
    with pytest.raises(ValueError, match="max_len"):
        package_merge(freqs, 0, 33, 4096)
    with pytest.raises(ValueError, match="int32"):
        package_merge(freqs.long(), 0, 18, 4096)
