"""Port decode (K1 plain version + K2) against the JAX Pallas decoder run
in interpret mode and against the numpy protocol twin, in translate mode
(the route's mode up to ``TRANSLATE_MAX_ALPHABET``) and in rank mode + K2
(past it, and the distributed decoder's) for every alphabet.

Exact equality on every word, garbage lanes and steps included: the codec
is bit-exact by design.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from huffman_tpu.bitio import pack_codes
from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import GROUP_LANES, MAX_SYMBOLS
from huffman_tpu.container import interleave as il
from huffman_tpu.ops import pallas_decode as pd
from huffman_tpu_torch.ops.cuda_decode import (
    TRANSLATE_MAX_ALPHABET,
    decode_groups,
    decode_groups_plain,
)
from huffman_tpu_torch.ops.cuda_gather import gather_u16_pairs
from huffman_tpu_torch.ops.tables import tables_from_codebook

CPU = torch.device("cpu")
PREFIX_BITS = 12  # csrc/decode.cu's kPrefixBits
DECODE_CASES = [(1, 12), (2, 12), (300, 12), (1024, 12), (1025, 12), (4000, 12),
                (1, 18), (2, 18), (300, 18), (1024, 18), (1025, 18), (4000, 18), (30000, 18)]


def _setup(seed, n_real, B, alphabet_size, max_len):
    """Interleaved streams of a random input with an odd tail (the last
    block is partial) over ``alphabet_size`` symbols, coded with the
    length-limited package-merge codebook at ``max_len``."""
    rng = np.random.default_rng(seed)
    n_lanes = -(-n_real // GROUP_LANES) * GROUP_LANES
    n_pairs = n_real * B - int(rng.integers(1, B))
    alphabet = rng.choice(MAX_SYMBOLS, size=alphabet_size, replace=False)
    if alphabet_size <= 300:  # skewed: exercises the length limit
        p = 1.0 / np.arange(1, alphabet_size + 1) ** 1.2
        symbols = rng.choice(alphabet, size=n_pairs, p=p / p.sum())
    else:  # uniform: every symbol occurs, so n_unique == alphabet_size
        symbols = np.concatenate(
            [alphabet, rng.choice(alphabet, size=n_pairs - alphabet_size)]
        )
        rng.shuffle(symbols)
    symbols = symbols.astype(np.uint16)
    freqs = np.bincount(symbols, minlength=MAX_SYMBOLS)
    cb = Codebook.from_lengths(package_merge_lengths(freqs, max_len))

    padded = np.zeros(n_lanes * B, dtype=np.uint16)
    padded[:n_pairs] = symbols
    lens = cb.lengths[padded].astype(np.int64)
    lens[n_pairs:] = 0
    codes = cb.codes[padded]
    rows = [  # each lane's real symbols only (no trailing padding)
        pack_codes(codes[l * B : min((l + 1) * B, n_pairs)],
                   lens[l * B : min((l + 1) * B, n_pairs)])[0]
        for l in range(n_real)
    ]
    slab = np.zeros((n_lanes, max(r.size for r in rows)), dtype=np.uint32)
    for i, r in enumerate(rows):
        slab[i, : r.size] = r
    eff = il.effective_lengths(lens.reshape(n_lanes, B), n_pairs, cb.lengths[cb.lengths > 0].min(), n_lanes, B)
    streams = il.build_interleaved_streams(slab, eff, n_real)
    return symbols, cb, streams


def _port_decode(cb, streams, n_real, B, translate=None):
    """The port's decode to symbol pairs, in ``translate`` mode or (None)
    the mode the decompress route picks for the alphabet."""
    stacked, _ = il.pad_streams(streams)
    ngroups = len(streams)
    t = tables_from_codebook(cb, CPU)
    n_real_g = np.clip(n_real - GROUP_LANES * np.arange(ngroups), 0, GROUP_LANES)
    if translate is None:
        translate = cb.n_unique <= TRANSLATE_MAX_ALPHABET
    out = decode_groups(
        torch.from_numpy(stacked.reshape(ngroups, -1).view(np.int32)),
        torch.from_numpy(n_real_g.astype(np.int32)),
        t, B, translate,
    )
    if not translate:
        out = gather_u16_pairs(out, t.sym_order)
    return out.numpy(), translate


def _jax_decode(cb, streams, n_real, B):
    """The JAX decoder's symbol pairs, in its own mode for the alphabet
    (translate up to its in-kernel tier, else ranks through
    ``sym_order_dev``): the same words as either of the port's modes."""
    stacked, _ = il.pad_streams(streams)
    ngroups = len(streams)
    rows_per = stacked.shape[0] // ngroups
    symtab, sym_rows, translate = pd.build_symtab(cb.sym_order)
    meta = np.zeros((ngroups, 4), dtype=np.int32)
    meta[:, 0] = np.clip(n_real - GROUP_LANES * np.arange(ngroups), 0, GROUP_LANES)
    out = pd.decode_groups(
        jnp.asarray(stacked), jnp.asarray(cb.lj_limit),
        jnp.asarray((cb.base & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray(symtab), jnp.asarray(meta), B, rows_per, sym_rows,
        max_len=max(cb.max_len, 1), translate=translate,
        min_len=int(cb.lengths[cb.lengths > 0].min()), interpret=True,
        sym_order_dev=None if translate else jnp.asarray(cb.sym_order.astype(np.int32)),
        packed_out=True,
    )
    return np.asarray(out)


def _check_decode(alphabet, max_len, translate=None):
    B, n_real = 32, 1500
    symbols, cb, streams = _setup(alphabet + max_len, n_real, B, alphabet, max_len)
    assert cb.n_unique == alphabet and cb.max_len <= max_len
    port, translate = _port_decode(cb, streams, n_real, B, translate)
    np.testing.assert_array_equal(port, _jax_decode(cb, streams, n_real, B))

    ngroups = len(streams)
    twin = np.stack([
        il.decode_interleaved_numpy(
            streams[g], cb, B, max(0, min(GROUP_LANES, n_real - g * GROUP_LANES))
        )
        for g in range(ngroups)
    ]).astype(np.uint32)  # (g, step, lane)
    pairs = twin[:, 0::2] | (twin[:, 1::2] << 16)
    np.testing.assert_array_equal(
        port.view(np.uint32).reshape(ngroups, B // 2, GROUP_LANES), pairs
    )
    dec = port.reshape(ngroups, B // 2, GROUP_LANES).transpose(0, 2, 1)
    dec = np.ascontiguousarray(dec).view("<u2").reshape(-1)[: symbols.size]
    np.testing.assert_array_equal(dec, symbols)
    return translate


@pytest.mark.parametrize("alphabet,max_len", DECODE_CASES)
def test_decode_groups_matches_jax_and_twin(alphabet, max_len):
    """The mode the decompress route picks: translate for every alphabet
    up to ``TRANSLATE_MAX_ALPHABET``."""
    assert _check_decode(alphabet, max_len) == (alphabet <= TRANSLATE_MAX_ALPHABET)


@pytest.mark.parametrize("alphabet,max_len", DECODE_CASES)
def test_decode_groups_rank_mode_matches_jax_and_twin(alphabet, max_len):
    """Rank mode + K2 at every alphabet size: the decode past the translate
    boundary and the distributed decoder's."""
    _check_decode(alphabet, max_len, translate=False)


def test_translate_boundary_is_the_kernels_capacity():
    """``TRANSLATE_MAX_ALPHABET`` is csrc/decode.cu's ``kMaxTranslate``,
    the table capacity its launch accepts."""
    src = (Path(__file__).resolve().parents[1] / "huffman_tpu_torch" / "csrc" / "decode.cu").read_text()
    assert int(re.search(r"constexpr int kMaxTranslate = (\d+);", src).group(1)) == TRANSLATE_MAX_ALPHABET
    assert TRANSLATE_MAX_ALPHABET >= 1024


@pytest.mark.parametrize("alphabet,max_len", [(300, 12), (1025, 18), (4000, 18)])
def test_unpacked_decode_matches_jax(alphabet, max_len):
    """``packed_out=False``: one symbol per int32 in JAX's (ngroups *
    n_steps, 8, 128) layout, in translate mode and in rank mode (the ranks
    translated by K5's plain version, as the JAX decoder translates them
    with ``sym_order_dev``), against the JAX decoder in its own mode."""
    B, n_real = 16, 1100
    symbols, cb, streams = _setup(alphabet + 7, n_real, B, alphabet, max_len)
    stacked, _ = il.pad_streams(streams)
    ngroups = len(streams)
    n_real_g = np.clip(n_real - GROUP_LANES * np.arange(ngroups), 0, GROUP_LANES)
    port = {
        mode: decode_groups(
            torch.from_numpy(stacked.reshape(ngroups, -1).view(np.int32)),
            torch.from_numpy(n_real_g.astype(np.int32)),
            tables_from_codebook(cb, CPU), B, mode, packed_out=False,
        )
        for mode in (True, False) if not mode or cb.n_unique <= TRANSLATE_MAX_ALPHABET
    }
    symtab, sym_rows, translate = pd.build_symtab(cb.sym_order)
    meta = np.zeros((ngroups, 4), dtype=np.int32)
    meta[:, 0] = n_real_g
    want = np.asarray(pd.decode_groups(
        jnp.asarray(stacked), jnp.asarray(cb.lj_limit),
        jnp.asarray((cb.base & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray(symtab), jnp.asarray(meta), B, stacked.shape[0] // ngroups, sym_rows,
        max_len=max(cb.max_len, 1), translate=translate,
        min_len=int(cb.lengths[cb.lengths > 0].min()), interpret=True,
        sym_order_dev=None if translate else jnp.asarray(cb.sym_order.astype(np.int32)),
        packed_out=False,
    ))
    assert len(port) == 2  # translate reaches every alphabet of these cases
    for got in port.values():
        assert got.shape == want.shape == (ngroups * B, 8, 128)
        np.testing.assert_array_equal(got.numpy(), want)
        dec = got.numpy().reshape(ngroups, B, GROUP_LANES).transpose(0, 2, 1).reshape(-1)
        np.testing.assert_array_equal(dec[: symbols.size], symbols)


def _table_length(lj, min_len, max_len, peek):
    """K1's length search (csrc/decode.cu) in numpy: the boundaries
    lj[min_len-1 : max_len-1] sorted; per 12-bit prefix of peek, the count
    of boundaries <= its first value and whether one lies inside it; a
    split prefix walks the sorted boundaries on from that count."""
    bounds = np.sort(lj[min_len - 1 : max_len - 1].astype(np.uint64))
    n = bounds.size
    shift = 32 - PREFIX_BITS
    first = np.arange(1 << PREFIX_BITS, dtype=np.uint64) << np.uint64(shift)
    c_lo = (bounds[None, :] <= first[:, None]).sum(axis=1)
    c_hi = (bounds[None, :] <= (first | np.uint64((1 << shift) - 1))[:, None]).sum(axis=1)
    p = (peek >> np.uint64(shift)).astype(np.int64)
    c, split = c_lo[p], (c_hi != c_lo)[p]
    for _ in range(n):
        c = c + (split & (c < n) & (bounds[np.minimum(c, max(n - 1, 0))] <= peek) if n else 0)
    return min_len + c


def _length_cases():
    for alphabet, max_len in DECODE_CASES:
        yield f"{alphabet}-{max_len}", lambda a=alphabet, m=max_len: _setup(a + m, 1500, 32, a, m)[1]
    fib = [1, 1]
    while len(fib) < 30:
        fib.append(fib[-1] + fib[-2])
    freqs = np.zeros(MAX_SYMBOLS, np.int64)
    freqs[:30] = fib
    yield "fibonacci-29bit", lambda: Codebook.from_lengths(package_merge_lengths(freqs, 32))


@pytest.mark.parametrize("case", [*(name for name, _ in _length_cases()), "unsorted boundaries"])
def test_prefix_table_length_is_the_compare_count(case):
    """The prefix-table search gives min_len + #(peek >= lj[i]) for every
    peek tried: each prefix's first and last value, every boundary and its
    neighbours, and random values; for unsorted boundaries as well."""
    rng = np.random.default_rng(len(case))
    if case == "unsorted boundaries":
        lj, min_len, max_len = rng.integers(0, 1 << 32, 32, dtype=np.uint64), 1, 32
    else:
        t = tables_from_codebook(dict(_length_cases())[case](), CPU)
        lj, min_len, max_len = t.lj_limit.numpy().view(np.uint32).astype(np.uint64), t.min_len, t.max_len
    shift = 32 - PREFIX_BITS
    first = np.arange(1 << PREFIX_BITS, dtype=np.uint64) << np.uint64(shift)
    near = lj[:, None].astype(np.int64) + np.arange(-1, 2)[None, :]
    peek = np.concatenate([first, first + np.uint64((1 << shift) - 1),
                           np.clip(near, 0, 0xFFFFFFFF).astype(np.uint64).reshape(-1),
                           rng.integers(0, 1 << 32, 100_000, dtype=np.uint64)])
    want = min_len + (peek[:, None] >= lj[None, min_len - 1 : max_len - 1]).sum(axis=1)
    np.testing.assert_array_equal(_table_length(lj, min_len, max_len, peek), want)


def test_decode_groups_rejects_odd_steps_and_wide_translate():
    _, cb, streams = _setup(0, 10, 8, 300, 18)
    t = tables_from_codebook(cb, CPU)
    s = torch.zeros((1, 4096), dtype=torch.int32)
    n = torch.tensor([10], dtype=torch.int32)
    with pytest.raises(ValueError, match="even"):
        decode_groups(s, n, t, 7, True)
    with pytest.raises(ValueError, match="int32"):
        decode_groups(s.to(torch.int64), n, t, 8, True)
    wide = t._replace(sym_order=torch.zeros(TRANSLATE_MAX_ALPHABET + 1, dtype=torch.int16))
    with pytest.raises(ValueError, match="translate"):
        decode_groups(s, n, wide, 8, True)


def test_plain_decode_is_the_wrapper_on_cpu():
    B, n_real = 16, 300
    _, cb, streams = _setup(11, n_real, B, 300, 18)
    stacked, _ = il.pad_streams(streams)
    s = torch.from_numpy(stacked.reshape(1, -1).view(np.int32))
    n = torch.tensor([n_real], dtype=torch.int32)
    t = tables_from_codebook(cb, CPU)
    assert torch.equal(decode_groups(s, n, t, B, True), decode_groups_plain(s, n, t, B, True))
