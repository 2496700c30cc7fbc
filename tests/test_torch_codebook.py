"""Port codebook construction against the JAX package: the package-merge
kernel's plain version (K7) against the Pallas kernel in interpret mode
and the XLA twin, the device canonical tables against both packages'
host codebooks, and the port's copied host codebook against the JAX
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
)

TIERS = (4096, 16384, 32768, 65536)


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
