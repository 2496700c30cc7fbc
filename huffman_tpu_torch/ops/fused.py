"""The fused device encode: counterpart of huffman_tpu/ops/fused.py
(``tiered_code_gather``, ``encode_device``, ``encode_device_bytes``,
``roundtrip_device``, ``encode_device_auto``), and ``encode_from_histogram``,
the encode from the histogram on, which the distributed encode
(``parallel/pipeline.py``) runs on an all-reduced histogram.

From the uploaded bytes to the interleaved streams with no host codebook:
histogram (K6) -> package-merge lengths at the input's alphabet tier (K7)
-> canonical tables (tensor ops) -> rank gather (K8 below
``CANON_GATHER_MIN_CAP``, K9 at and above it, K9 with identity addressing
at the full alphabet) -> lane pack (K4) and stream deposit (K10). The host
reads back the alphabet size (to pick the tier), the groups' largest word
total (to size the stream buffer), the (65536,) lengths (for the header)
and the trimmed streams. Length limits of 27..32 bits do not fit the
rank gathers' ``len << 26 | code`` word: there the codes come from the
canonical tables by the two-table gather of ``ops/encode.py``, as the JAX
package's ``gather="xla"`` tier does.

The JAX package selects the tier inside one program with ``lax.switch``;
here the wrapper reads ``n_unique`` once and runs only that tier's kernels.
Containers do not depend on the tier: package-merge lengths are the same
for any cap >= n_unique, and every gather scheme gives the same codes.
"""

from __future__ import annotations

import torch

from ..constants import ALPHABET_TIERS, GROUP_LANES, MAX_CODE_LEN, MAX_SYMBOLS
from ..u32 import narrow, widen
from . import decode as dec
from . import encode as enc
from .cuda_encode import encode_streams
from .cuda_gather import (
    RANK_WORDS,
    build_rank_select,
    gather_rank_canonical,
    gather_rank_select,
)
from .cuda_hist import histogram
from .device_codebook import device_canonical_tables, device_code_lengths
from .histogram import bytes_to_symbols_device
from .tables import PACKED_MAX_LEN

# Tiers with at least this cap gather through canonical ranks (K9), smaller
# ones through the packed-code rank-select table (K8). Measured on the H100
# (PERF.md §6, the route A/Bs): at tier 4096 the whole
# tiered_code_gather with K9 is not faster than with K8 by more than the
# spread of either (table building and K7 dwarf the kernels' difference),
# so the boundary stays where it was.
CANON_GATHER_MIN_CAP = 16384


def tier_for(n_unique: int) -> int:
    """The smallest alphabet cap of ``ALPHABET_TIERS`` that holds
    ``n_unique`` symbols."""
    return next(t for t in ALPHABET_TIERS if t >= n_unique)


def tiered_code_gather(
    hist: torch.Tensor,     # (65536,) int32 histogram of the valid symbols
    n_unique: int,          # its non-zero bins
    symbols: torch.Tensor,  # (n_lanes, B) int16 bits of u16 symbols
    n_valid: int,
    *,
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Codebook and symbol gather at the input's tier. Returns (lengths
    (65536,) int32, codes, lens, tier cap); codes and lens are 0 at
    positions at or past ``n_valid``."""
    cap = tier_for(n_unique)
    lengths = device_code_lengths(hist, max_len, cap, n_unique)
    tabs = device_canonical_tables(lengths)
    gather = rank_select_codes if cap < CANON_GATHER_MIN_CAP else canonical_rank_codes
    codes, lens = gather(tabs, lengths > 0, cap, symbols, n_valid, max_len)
    return lengths, codes, lens, cap


def rank_select_codes(tabs, present, cap, symbols, n_valid, max_len):
    """(codes, lens) by K8: the packed ``len << 26 | code`` words of the
    present symbols in a rank-select table of ``cap`` entries."""
    enc_packed = narrow((widen(tabs.enc_lens) << 26) | widen(tabs.enc_codes))
    maskw, cums, dense = build_rank_select(enc_packed, present, cap)
    return gather_rank_select(symbols, n_valid, maskw, cums, dense)


def canonical_rank_codes(tabs, present, cap, symbols, n_valid, max_len):
    """(codes, lens) by K9: each symbol's canonical rank from a packed-16
    table (a rank-select stage below the full alphabet, addressed by the
    symbol itself at it), then its length and code from ``start`` and
    ``base``."""
    identity = cap >= MAX_SYMBOLS
    if identity:
        # Every symbol slot has an entry: the table is sym_rank itself,
        # addressed by the symbol, and the rank stage is skipped.
        ranks = tabs.sym_rank.to(torch.int64)
        maskw = torch.zeros(RANK_WORDS, dtype=torch.int32, device=symbols.device)
        cums = torch.zeros_like(maskw)
    else:
        maskw, cums, dense = build_rank_select(tabs.sym_rank, present, cap)
        ranks = widen(dense)
    canon16 = narrow(ranks[0::2] | (ranks[1::2] << 16))
    return gather_rank_canonical(
        symbols, n_valid, maskw, cums, canon16, tabs.start, tabs.base,
        max_len, identity,
    )


def encode_device(
    symbols: torch.Tensor,  # (n_lanes, B) int16 bits, n_lanes % 1024 == 0
    n_pairs: int,           # real symbols (row-major); the rest is padding
    max_len: int,
) -> dict:
    """Fused encode. Returns a dict with the interleaved payload
    (``streams`` (ngroups, 2048 + words_cap) int32 bits and ``counts``
    (ngroups,) words per group), the dense code ``lengths`` (65536,) int32,
    the histogram ``hist`` and the alphabet ``tier`` that ran."""
    hist = histogram(symbols, n_pairs)
    return {**encode_from_histogram(symbols, n_pairs, hist, max_len), "hist": hist}


def encode_from_histogram(
    symbols: torch.Tensor,  # (n_lanes, B) int16 bits, n_lanes % 1024 == 0
    n_valid: int,           # real symbols (row-major); the rest is padding
    hist: torch.Tensor,     # (65536,) int32 histogram the codebook is built from
    max_len: int,
) -> dict:
    """``encode_device`` from the codebook's histogram on: the codebook
    comes from ``hist``, which may count more than these symbols (the
    all-reduced histogram of a distributed encode). Returns ``streams``,
    ``counts``, ``lengths`` and ``tier`` as ``encode_device`` does."""
    n_lanes, B = symbols.shape
    if n_lanes % GROUP_LANES:
        raise ValueError("n_lanes must be a multiple of GROUP_LANES")
    if not 1 <= max_len <= MAX_CODE_LEN:
        raise ValueError(f"max_len={max_len} outside [1, {MAX_CODE_LEN}]")
    n_unique = int((hist > 0).sum())  # the one read that picks the tier
    if n_unique > (1 << max_len):
        raise ValueError(
            f"max_len={max_len} cannot encode {n_unique} distinct symbols"
        )
    if max_len <= PACKED_MAX_LEN:
        lengths, codes, lens, cap = tiered_code_gather(
            hist, n_unique, symbols, n_valid, max_len=max_len
        )
    else:
        cap = tier_for(n_unique)
        lengths = device_code_lengths(hist, max_len, cap, n_unique)
        tabs = device_canonical_tables(lengths)
        codes, lens = enc.gather_codes(symbols, tabs.enc_codes, tabs.enc_lens, n_valid)
    min_len = torch.where(lengths > 0, lengths, MAX_CODE_LEN).min()
    n_real = -(-n_valid // B)
    streams, counts = encode_streams(codes, lens, n_valid, min_len, n_real)
    return {"streams": streams, "counts": counts, "lengths": lengths, "tier": cap}


def encode_device_bytes(
    data_bytes: torch.Tensor,  # (n_lanes * B * 2,) uint8, zero-padded
    n_pairs: int,
    B: int,
    max_len: int,
) -> dict:
    """Container front end of ``encode_device``: the raw bytes go up, and
    the byte-pair symbols are a view of them on the device."""
    symbols = bytes_to_symbols_device(data_bytes).reshape(-1, B)
    return encode_device(symbols, n_pairs, max_len)


# The JAX package's encode_device_auto reruns encode_device on its exact
# tier when the fast tier cannot take the length limit; here encode_device
# takes every limit in one call.
encode_device_auto = encode_device


def roundtrip_device(
    symbols: torch.Tensor,  # (n_lanes, B) int16 bits, n_lanes % 1024 == 0
    n_pairs: int,
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode on the device, decode there, compare: the fused encode, then
    per-block slabs rebuilt from its code lengths (two-table gather,
    ``pack_blocks``) decoded by ``decode_blocks``. Returns (ok, the
    payload's word total), both 0-dim tensors on the device."""
    n_lanes, B = symbols.shape
    r = encode_device(symbols, n_pairs, max_len)
    tabs = device_canonical_tables(r["lengths"])
    codes, lens = enc.gather_codes(symbols, tabs.enc_codes, tabs.enc_lens, n_pairs)
    offsets, _ = enc.block_offsets(lens)
    slab = enc.pack_blocks(codes, lens, offsets, B)
    present = r["lengths"] > 0
    sym_order = torch.zeros(MAX_SYMBOLS, dtype=torch.int64, device=symbols.device)
    sym_order[tabs.sym_rank[present].long()] = torch.nonzero(present)[:, 0]
    dec_max_len = max(int(r["lengths"].max()), 1)
    out = dec.decode_blocks(slab, tabs.lj_limit, tabs.base, sym_order, B, dec_max_len)
    valid = torch.arange(n_lanes * B, device=symbols.device).reshape(n_lanes, B) < n_pairs
    sym = symbols.to(torch.int32) & 0xFFFF
    ok = torch.where(valid, out == sym, True).all()
    return ok, r["counts"].sum()
