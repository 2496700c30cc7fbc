"""Canonical Huffman codebooks on the host: the port's own copy of the
parts of huffman_tpu/codebook.py it uses, in NumPy only.

* ``package_merge_lengths``: optimal length-limited code lengths (boundary
  package-merge), the construction the fused device encoder runs on the
  card (``ops/device_codebook.py``) and the host codebook route runs here.
  Both order leaves by (weight, symbol) and break leaf/package weight ties
  leaves first, so they derive the same codebook and the same container.
* ``code_lengths_from_frequencies``: the unlimited two-queue Huffman code
  (``max_code_len=None``), with deterministic (freq, symbol) tie-breaking,
  by the native runtime (``runtime/native.py``) where it is available.
* ``Codebook``: canonical codes and the dense tables the kernels read.

A codebook built by the JAX package carries over as its lengths:
``Codebook.from_lengths(np.asarray(jax_codebook.lengths))`` rebuilds it
exactly, since a canonical code is a function of its lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import MAX_CODE_LEN, MAX_SYMBOLS
from .runtime import native


def code_lengths_from_frequencies(freqs: np.ndarray) -> np.ndarray:
    """Optimal prefix-code lengths for a dense frequency table: (MAX_SYMBOLS,)
    uint8, 0 for absent symbols. A single unique symbol gets length 1 (the
    degenerate tree). A dense table goes to the native runtime's two-queue
    builder (same algorithm, same tie-breaking) where it is available; only
    a library that cannot be loaded falls through to the Python loop below,
    and its validation errors (negative counts: ``NativeError``) propagate."""
    freqs = np.asarray(freqs)
    if freqs.shape == (MAX_SYMBOLS,) and native.available():
        return native.code_lengths(freqs)
    present = np.flatnonzero(freqs)
    n = present.size
    lengths = np.zeros(MAX_SYMBOLS, dtype=np.uint8)
    if n == 0:
        return lengths
    if n == 1:
        lengths[present[0]] = 1
        return lengths

    # Leaves sorted ascending by (freq, symbol): deterministic tie-break.
    leaf_freq = freqs[present].astype(np.int64)
    order = np.lexsort((present, leaf_freq))
    leaf_freq = leaf_freq[order]
    leaf_sym = present[order]

    # Two-queue merge. Queue 1: sorted leaves. Queue 2: internal nodes in
    # creation order (their frequencies are non-decreasing by construction).
    # Ties prefer the internal node: that is part of the container contract
    # (the JAX package's host code and its native twin do the same).
    int_freq = np.empty(n - 1, dtype=np.int64)
    left = np.empty(n - 1, dtype=np.int64)   # child ids; leaves are [0, n)
    right = np.empty(n - 1, dtype=np.int64)  # internals are n + k
    li = 0  # next leaf
    ii = 0  # next internal to consume
    for k in range(n - 1):
        picks = []
        for _ in range(2):
            take_leaf = li < n and (ii >= k or leaf_freq[li] < int_freq[ii])
            if take_leaf:
                picks.append((li, leaf_freq[li]))
                li += 1
            else:
                picks.append((n + ii, int_freq[ii]))
                ii += 1
        (a, fa), (b, fb) = picks
        int_freq[k] = fa + fb
        left[k] = a
        right[k] = b

    # Depth of each leaf = code length. Walk internals root-first.
    depth = np.zeros(2 * n - 1, dtype=np.int64)
    for k in range(n - 2, -1, -1):
        d = depth[n + k] + 1
        depth[left[k]] = d
        depth[right[k]] = d

    leaf_depth = depth[:n]
    if leaf_depth.max() > MAX_CODE_LEN:
        # Pathological frequency profile; length-limited rebuild.
        leaf_depth = _limit_lengths(leaf_freq, MAX_CODE_LEN)
    lengths[leaf_sym] = leaf_depth.astype(np.uint8)
    return lengths


def _limit_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Optimal length-limited lengths of ascending ``freqs`` via boundary
    package-merge; returned in the same (rank) order."""
    n = freqs.size
    leaf_w = np.sort(freqs.astype(np.float64))
    # Level lists: weights plus is-package flags; leaves merge in sorted.
    cur_w = leaf_w
    flags_by_level = [np.zeros(n, dtype=bool)]
    for _ in range(limit - 1):
        pk = cur_w[0 : cur_w.size - (cur_w.size % 2)]
        pk = pk[0::2] + pk[1::2]
        w = np.concatenate([leaf_w, pk])
        f = np.concatenate(
            [np.zeros(n, dtype=bool), np.ones(pk.size, dtype=bool)]
        )
        order = np.argsort(w, kind="stable")
        cur_w = w[order]
        flags_by_level.append(f[order])

    lengths_by_rank = np.zeros(n, dtype=np.int64)
    c = 2 * n - 2
    ranks = np.arange(n)
    for lvl in range(limit - 1, -1, -1):
        flags = flags_by_level[lvl]
        p = int(flags[:c].sum())
        m = c - p
        lengths_by_rank += ranks < m
        c = 2 * p
    return lengths_by_rank


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Dense optimal length-limited code lengths: (MAX_SYMBOLS,) uint8, 0
    for absent symbols. ``max_len`` above MAX_CODE_LEN clamps to it; a limit
    too small for the alphabet (n_unique > 2**max_len) raises."""
    max_len = min(max_len, MAX_CODE_LEN)
    lengths = np.zeros(MAX_SYMBOLS, dtype=np.uint8)
    present = freqs > 0
    n = int(present.sum())
    if n == 0:
        return lengths
    sym = np.flatnonzero(present)
    if n == 1:
        lengths[sym] = 1  # the degenerate 1-bit code
        return lengths
    if n > (1 << max_len):
        raise ValueError(
            f"max_len={max_len} cannot encode {n} distinct symbols "
            f"(needs >= {int(np.ceil(np.log2(n)))} bits)"
        )
    w = freqs[sym].astype(np.int64)
    order = np.lexsort((sym, w))  # ascending (weight, symbol)
    lengths[sym[order]] = _limit_lengths(w[order], max_len).astype(np.uint8)
    return lengths


@dataclass(frozen=True)
class Codebook:
    """Canonical Huffman codebook plus dense device-friendly tables.

    Attributes
    ----------
    lengths : (MAX_SYMBOLS,) uint8 — code length per symbol, 0 if absent.
    codes : (MAX_SYMBOLS,) uint32 — right-justified canonical codeword.
    sym_order : (n_unique,) uint16 — symbols sorted by (length, symbol),
        i.e. canonical order; ``sym_order[rank]`` inverts encoding.
    lj_limit : (MAX_CODE_LEN,) uint32 — left-justified exclusive upper
        boundary of codes of length l+1; boundaries of 2^32 saturate to
        0xFFFFFFFF.
    lj_first : (MAX_CODE_LEN + 1,) uint32 — left-justified first code of
        each length (index by len, entry 0 unused).
    base : (MAX_CODE_LEN + 1,) int64 — ``cum_count_shorter[l] -
        first_code[l]``, so that ``rank = base[len] + (peek32 >> (32 -
        len))``; device tables wrap it mod 2^32, which keeps rank
        arithmetic exact.
    """

    lengths: np.ndarray
    codes: np.ndarray
    sym_order: np.ndarray
    lj_limit: np.ndarray
    lj_first: np.ndarray
    base: np.ndarray

    @property
    def n_unique(self) -> int:
        return int(self.sym_order.size)

    @property
    def max_len(self) -> int:
        return int(self.lengths.max(initial=0))

    @staticmethod
    def from_lengths(lengths: np.ndarray) -> "Codebook":
        lengths = np.asarray(lengths, dtype=np.uint8)
        if lengths.shape != (MAX_SYMBOLS,):
            raise ValueError("lengths must be a dense MAX_SYMBOLS table")
        present = np.flatnonzero(lengths)
        lens = lengths[present].astype(np.int64)
        order = np.lexsort((present, lens))
        sym_order = present[order].astype(np.uint16)
        sorted_lens = lens[order]

        # Canonical code assignment: first[l+1] = (first[l] + count[l]) << 1.
        count = np.bincount(sorted_lens, minlength=MAX_CODE_LEN + 1).astype(np.int64)
        first = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
        for l in range(1, MAX_CODE_LEN + 1):
            first[l + 1] = (first[l] + count[l]) << 1
        # Kraft check: the boundary after the deepest length closes at 2^L,
        # except for the deliberately degenerate single-symbol codebook.
        L = int(sorted_lens.max(initial=0))
        if L and sym_order.size > 1 and (first[L] + count[L]) != (1 << L):
            raise ValueError("code lengths violate the Kraft equality")

        codes = np.zeros(MAX_SYMBOLS, dtype=np.uint32)
        if sym_order.size:
            rank_in_len = np.arange(sym_order.size, dtype=np.int64)
            cum = np.concatenate(([0], np.cumsum(count)))
            rank_in_len -= cum[sorted_lens]
            codes[sym_order] = (first[sorted_lens] + rank_in_len).astype(np.uint32)

        lj_first = np.zeros(MAX_CODE_LEN + 1, dtype=np.uint32)
        lj_limit = np.full(MAX_CODE_LEN, 0xFFFFFFFF, dtype=np.uint32)
        for l in range(1, MAX_CODE_LEN + 1):
            lj_first[l] = (first[l] << (32 - l)) & 0xFFFFFFFF
            bound = (first[l] + count[l]) << (32 - l)
            lj_limit[l - 1] = min(bound, 0xFFFFFFFF)

        base = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
        cum = np.concatenate(([0], np.cumsum(count[1:])))
        for l in range(1, MAX_CODE_LEN + 1):
            base[l] = cum[l - 1] - first[l]
        return Codebook(
            lengths=lengths,
            codes=codes,
            sym_order=sym_order,
            lj_limit=lj_limit,
            lj_first=lj_first,
            base=base,
        )

    @staticmethod
    def from_frequencies(freqs: np.ndarray) -> "Codebook":
        return Codebook.from_lengths(code_lengths_from_frequencies(freqs))

    def expected_bits(self, freqs: np.ndarray) -> int:
        """Total payload bits = sum freq * len (optimality invariant)."""
        return int(np.sum(freqs.astype(np.int64) * self.lengths.astype(np.int64)))
