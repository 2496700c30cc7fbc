"""Port lookups (K2, K3, K5 plain versions) against the JAX Pallas gathers
run in interpret mode. Exact equality."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import MAX_SYMBOLS
from huffman_tpu.ops import pallas_decode as pd
from huffman_tpu.ops.pallas_gather import (
    build_displacement_table,
    gather_packed32_dense,
    gather_table_pallas,
    gather_u16_pairs_pallas,
    gather_u16_pallas,
)
from huffman_tpu_torch.ops.cuda_gather import (
    gather_codes,
    gather_codes_plain,
    gather_u16,
    gather_u16_pairs,
    gather_u16_pairs_plain,
)
from huffman_tpu_torch.ops.tables import tables_from_codebook

CPU = torch.device("cpu")


def _codebook(seed, n_unique, max_len=18):
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(MAX_SYMBOLS, size=n_unique, replace=False)
    freqs = np.zeros(MAX_SYMBOLS, np.int64)
    freqs[alphabet] = rng.integers(1, 1000, size=n_unique)
    return Codebook.from_lengths(package_merge_lengths(freqs, max_len)), alphabet


@pytest.mark.parametrize("n_unique", [1025, 4000])
def test_gather_u16_pairs_matches_pallas(n_unique):
    cb, _ = _codebook(n_unique, n_unique)
    rng = np.random.default_rng(1)
    n_words = 8 * 1024  # one interpret-mode grid cell
    lo = rng.integers(0, n_unique, n_words, dtype=np.uint32)
    hi = rng.integers(0, n_unique, n_words, dtype=np.uint32)
    packed_idx = (lo | (hi << 16)).view(np.int32).reshape(8, 8, 128)

    # The JAX decoder's packed-16 table, as decode_groups builds it.
    rows = pd._pack_rows_for(n_unique)
    so = cb.sym_order.astype(np.uint32)
    even = np.zeros(rows * 128, np.uint32)
    odd = np.zeros(rows * 128, np.uint32)
    even[: (n_unique + 1) // 2] = so[0::2]
    odd[: n_unique // 2] = so[1::2]
    want = np.asarray(
        gather_u16_pairs_pallas(jnp.asarray(packed_idx), jnp.asarray(even | (odd << 16)), interpret=True)
    )

    t = tables_from_codebook(cb, CPU)
    got = gather_u16_pairs(torch.from_numpy(packed_idx), t.sym_order)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32).reshape(-1), so[lo] | (so[hi] << 16)
    )


@pytest.mark.parametrize("n_unique", [1, 3000])
def test_gather_u16_matches_pallas(n_unique):
    """The unpacked rank-mode translation: int32 ranks in any shape through
    the JAX decoder's packed-16 table (which the caller feeds clipped
    ranks), and past the table the clamp of ``jnp.take(mode="clip")``."""
    rng = np.random.default_rng(n_unique)
    table = rng.integers(0, 1 << 16, n_unique).astype(np.uint16)
    idx = rng.integers(0, n_unique, (8, 8, 128)).astype(np.int32)  # one grid cell
    rows = pd._pack_rows_for(n_unique)
    even = np.zeros(rows * 128, np.uint32)
    odd = np.zeros(rows * 128, np.uint32)
    even[: (n_unique + 1) // 2] = table[0::2]
    odd[: n_unique // 2] = table[1::2]
    want = np.asarray(gather_u16_pallas(jnp.asarray(idx), jnp.asarray(even | (odd << 16)), interpret=True))
    t = torch.from_numpy(table.view(np.int16))
    got = gather_u16(torch.from_numpy(idx), t)
    assert got.dtype == torch.int32 and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(), want)

    wild = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table.astype(np.int32)), jnp.asarray(wild), mode="clip"))
    np.testing.assert_array_equal(gather_u16(torch.from_numpy(wild), t).numpy(), want)


def test_gather_u16_pairs_clips_past_the_table():
    sym = torch.tensor([5, 6, 7], dtype=torch.int16)
    idx = torch.tensor([0 | (2 << 16), 3 | (9 << 16), 0xFFFF | (1 << 16)], dtype=torch.int32)
    got = gather_u16_pairs_plain(idx, sym).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, [5 | (7 << 16), 7 | (7 << 16), 7 | (6 << 16)])


def _symbols(alphabet, n, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(alphabet, size=n).astype(np.uint16)


@pytest.mark.parametrize("n_unique,n_valid", [(300, 8 * 1024), (3000, 8 * 1024 - 77)])
def test_gather_codes_matches_displacement_pallas(n_unique, n_valid):
    cb, alphabet = _codebook(n_unique + 7, n_unique)
    packed = (cb.lengths.astype(np.uint32) << 26) | cb.codes.astype(np.uint32)
    disp, table = build_displacement_table(packed, cb.lengths > 0)
    sym = _symbols(alphabet, 8 * 1024, 2).reshape(8, 1024)
    out = np.asarray(
        gather_table_pallas(jnp.asarray(sym.astype(np.int32)), jnp.asarray(disp), jnp.asarray(table), interpret=True)
    )
    valid = np.arange(sym.size).reshape(sym.shape) < n_valid
    want_codes = np.where(valid, out & ((1 << 26) - 1), 0)
    want_lens = np.where(valid, out >> 26, 0)

    t = tables_from_codebook(cb, CPU)
    codes, lens = gather_codes(torch.from_numpy(sym.view(np.int16)), t.enc_packed, n_valid)
    np.testing.assert_array_equal(codes.numpy().view(np.uint32), want_codes)
    np.testing.assert_array_equal(lens.numpy(), want_lens)


def test_gather_codes_matches_dense_pallas():
    cb, alphabet = _codebook(9, 30000)
    packed = (cb.lengths.astype(np.uint32) << 26) | cb.codes.astype(np.uint32)
    sym = _symbols(alphabet, 8 * 1024, 3)
    out = np.asarray(
        gather_packed32_dense(jnp.asarray(sym.astype(np.int32)), jnp.asarray(packed), interpret=True)
    )
    t = tables_from_codebook(cb, CPU)
    codes, lens = gather_codes_plain(torch.from_numpy(sym.view(np.int16)), t.enc_packed, sym.size)
    np.testing.assert_array_equal(codes.numpy().view(np.uint32), out & ((1 << 26) - 1))
    np.testing.assert_array_equal(lens.numpy(), out >> 26)
    np.testing.assert_array_equal(lens.numpy(), cb.lengths[sym])
