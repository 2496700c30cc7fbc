"""On-device codebook construction: counterpart of
huffman_tpu/ops/device_codebook.py.

* ``package_merge`` (K7): boundary package-merge from the dense histogram
  to code lengths by leaf rank and the leaf symbols, the contract of
  ``_pm_pallas``. The CUDA kernel (``csrc/package_merge.cu``) for CUDA
  tensors, ``package_merge_plain`` for CPU tensors.
* ``device_code_lengths``: the dense (65536,) lengths, with the
  single-symbol rule of ``_finish_lengths``.
* ``device_canonical_tables``: canonical codes, decode boundaries, the
  ``base`` table and canonical ranks, as plain tensor ops (XLA ops in the
  JAX package, no kernel there either).

The lengths equal the host ``codebook.package_merge_lengths`` for any cap
K >= n_unique: sentinel-padded tails never enter the level counts. That
is what makes fused-route containers byte-identical to host-route ones.
Weights are int32 histogram counts below 2**30; package sums saturate at
``_INF`` = 2**30, the weight of absent symbols.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import MAX_CODE_LEN, MAX_SYMBOLS
from ..runtime import kernels
from ..u32 import MASK32, narrow

_INF = 1 << 30


def package_merge(
    freqs: torch.Tensor, n: int, max_len: int, K: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``freqs``: (n_sym,) int32 dense histogram, n_sym a power of two up
    to 65536, every weight below 2**30; ``n``: its count of bins with
    f > 0; ``K``: the alphabet cap, a power of two <= n_sym. Returns
    (lengths_by_rank (K,), leaf_sym (K,)) int32; exact while n <= K.

    On the card the C entry point picks its route from the arguments:
    for K <= 4096 and n <= K one kernel of one block does the whole
    function (the tier of every input with at most 4096 distinct pairs);
    otherwise the sort, merge and round launches run, then the count."""
    dev = freqs.device
    kernels.check(freqs, torch.int32, dev, "freqs")
    n_sym = freqs.numel()
    if freqs.dim() != 1 or n_sym & (n_sym - 1) or not 2 <= n_sym <= MAX_SYMBOLS:
        raise ValueError("freqs must be (n_sym,) with n_sym a power of two <= 65536")
    if K & (K - 1) or not 1 <= K <= n_sym:
        raise ValueError(f"K={K} must be a power of two in [1, {n_sym}]")
    if not 1 <= max_len <= MAX_CODE_LEN:
        raise ValueError(f"max_len={max_len} outside [1, {MAX_CODE_LEN}]")
    if dev.type == "cuda":
        out = torch.empty((2, K), dtype=torch.int32, device=dev)
        scratch, pointers = kernel_scratch(n_sym, K, max_len, dev)
        kernels.launch(
            "package_merge", freqs.data_ptr(), n_sym, n, K, max_len, *pointers,
            out.data_ptr(), out.data_ptr() + 4 * K,
        )
        lengths, leaf_sym = out
        return lengths, leaf_sym
    if dev.type == "cpu":
        return package_merge_plain(freqs, n, max_len, K)
    raise ValueError(f"package_merge: unsupported device {dev}")


def kernel_scratch(
    n_sym: int, K: int, max_len: int, dev: torch.device
) -> tuple[torch.Tensor, list[int]]:
    """One device buffer holding the kernel's scratch, and the pointers of
    its parts in the C entry point's order: the sort keys (2 x (n_sym,)
    u64), the leaf keys (K,) u32, the two lists (2 x (2K,) u32) and the
    rounds' leaf positions ((max_len - 1) x K int32). Keep the buffer
    alive until the launch returns."""
    sizes = (8 * n_sym, 8 * n_sym, 4 * K, 8 * K, 8 * K, 4 * K * max(max_len - 1, 1))
    offsets = [0]
    for size in sizes[:-1]:
        offsets.append(offsets[-1] + -(-size // 256) * 256)
    scratch = torch.empty(offsets[-1] + sizes[-1], dtype=torch.uint8, device=dev)
    return scratch, [scratch.data_ptr() + o for o in offsets]


def package_merge_plain(
    freqs: torch.Tensor, n: int, max_len: int, K: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the kernel's three stages as tensor ops
    (a sort of the unique (weight, symbol) keys; per round, merge positions
    by ``searchsorted``; the counting pass with the count kept on the
    device)."""
    dev = freqs.device
    f = freqs.to(torch.int64)
    w = torch.where(f > 0, f, _INF)
    keys = torch.sort((w << 16) | torch.arange(f.numel(), device=dev)).values[:K]
    leaf_sym = keys & 0xFFFF
    leaf_keys = (keys >> 16) << 1
    x = torch.cat([leaf_keys, torch.full((K,), _INF << 1, device=dev)])
    own = torch.arange(K, device=dev)
    flags = []
    for _ in range(max_len - 1):
        a, b = x[0::2] >> 1, x[1::2] >> 1
        pw = torch.where((a >= _INF) | (b >= _INF), _INF, torch.clamp(a + b, max=_INF))
        pkeys = (pw << 1) | 1
        x = torch.empty(2 * K, dtype=torch.int64, device=dev)
        x[own + torch.searchsorted(pkeys, leaf_keys)] = leaf_keys
        x[own + torch.searchsorted(leaf_keys, pkeys)] = pkeys
        flags.append(x & 1)

    lengths = torch.zeros(K, dtype=torch.int64, device=dev)
    ranks = torch.arange(K, device=dev)
    items = torch.arange(2 * K, device=dev)
    c = torch.tensor(max(2 * n - 2, 0), device=dev)
    for level in range(max_len - 1, 0, -1):
        p = torch.where(items < c, flags[level - 1], 0).sum()
        lengths += ranks < c - p
        c = 2 * p
    lengths += ranks < c  # the leaves' level: no packages
    return lengths.to(torch.int32), leaf_sym.to(torch.int32)


def device_code_lengths(
    freqs: torch.Tensor,
    max_len: int,
    alphabet_cap: int,
    n_unique: int,
) -> torch.Tensor:
    """Optimal length-limited code lengths of a (65536,) int32 histogram
    with ``n_unique`` non-zero bins: (65536,) int32, 0 for absent symbols.
    ``alphabet_cap`` (a power of two, the alphabet tier) bounds the
    package-merge lists; the result is exact while n_unique fits it."""
    by_rank, leaf_sym = package_merge(freqs, n_unique, max_len, alphabet_cap)
    return _finish_lengths(by_rank, leaf_sym, freqs > 0, n_unique)


def _finish_lengths(by_rank, leaf_sym, present, n):
    if n == 1:
        # The counting pass gives the lone leaf length 0 (c starts at 0):
        # force the degenerate 1-bit code.
        by_rank = by_rank.clone()
        by_rank[0] = 1
    lengths = torch.zeros(present.numel(), dtype=torch.int32, device=present.device)
    lengths[leaf_sym.long()] = by_rank
    return torch.where(present, lengths, 0)


class CanonicalTables(NamedTuple):
    enc_codes: torch.Tensor  # (n_sym,) int32 bits of u32 right-justified codes
    enc_lens: torch.Tensor   # (n_sym,) int32 code lengths
    lj_limit: torch.Tensor   # (MAX_CODE_LEN,) int32 bits of u32 boundaries
    base: torch.Tensor       # (MAX_CODE_LEN + 1,) int32 bits, wrapped mod 2^32
    sym_rank: torch.Tensor   # (n_sym,) int32 canonical rank, absent symbols last
    start: torch.Tensor      # (MAX_CODE_LEN + 1,) int32: #codes shorter than l


def device_canonical_tables(lengths: torch.Tensor) -> CanonicalTables:
    """Canonical code tables of a dense length table, on its device: the
    counterpart of ``device_canonical_tables`` (and of the host
    ``Codebook.from_lengths``). Exact int64 arithmetic, wrapped to u32 bit
    patterns at the end."""
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    n_sym = lengths.numel()
    ls = torch.arange(MAX_CODE_LEN + 1, device=dev)
    # count[l] = #codes of length l (count[0] = 0)
    count = (lengths[None, :] == ls[:, None]).sum(dim=1)
    count[0] = 0
    # first[l] = canonical first code of length l: first[l+1] =
    # (first[l] + count[l]) << 1, i.e. sum over k < l of count[k] << (l-k).
    k = ls[None, :]
    l = ls[:, None]
    first = torch.where(
        (k >= 1) & (k < l), count[None, :] << (l - k).clamp(min=0), 0
    ).sum(dim=1)
    shorter = torch.cumsum(count, dim=0) - count  # #codes with length < l

    # Canonical rank: order by (length, symbol), absent symbols last.
    sort_len = torch.where(lengths > 0, lengths, MAX_CODE_LEN + 1)
    order = torch.argsort(sort_len * n_sym + torch.arange(n_sym, device=dev))
    sym_rank = torch.empty(n_sym, dtype=torch.int64, device=dev)
    sym_rank[order] = torch.arange(n_sym, device=dev)

    rank_in_len = sym_rank - shorter[lengths]
    enc_codes = torch.where(lengths > 0, first[lengths] + rank_in_len, 0)
    bound = (first[1:] + count[1:]) << (32 - ls[1:])
    lj_limit = torch.clamp(bound, max=MASK32)
    base = shorter - first
    return CanonicalTables(
        enc_codes=narrow(enc_codes),
        enc_lens=lengths.to(torch.int32),
        lj_limit=narrow(lj_limit),
        base=narrow(base),
        sym_rank=sym_rank.to(torch.int32),
        start=shorter.to(torch.int32),
    )
