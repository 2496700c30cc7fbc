"""Code gather and bit packing as tensor ops: counterpart of
huffman_tpu/ops/encode.py (XLA ops in the JAX package, no kernel there
either).

* ``gather_codes``: symbol -> (code, length) through two dense tables, for
  codebooks deeper than the 26 bits that K3's ``len << 26 | code`` word
  holds.
* ``block_offsets``: in-block exclusive bit offsets and block totals.
* ``pack_blocks``: per-block streams into an ``(nblocks, W)`` word slab,
  each block from bit 0 of its own row.
* ``pack_stream``: one continuous stream (the reference container's
  payload) from ``(word, bit)`` offset pairs, so global offsets may pass
  2**31.

Stream convention: bit p of a stream is bit ``31 - p % 32`` of word
``p // 32``. Codewords occupy disjoint bits, so adding their parts equals
OR-ing them: the scatter-adds accumulate in int64 and keep the low 32 bits,
so no signed 32-bit add ever overflows. Indices past the output are dropped,
as XLA's ``mode="drop"`` does.
"""

from __future__ import annotations

import torch

from ..u32 import narrow, shl, widen


def gather_codes(
    symbols: torch.Tensor,    # int16 bits of u16 symbols, any shape
    enc_codes: torch.Tensor,  # (65536,) int32 bits of the u32 codes
    enc_lens: torch.Tensor,   # (65536,) int32 code lengths
    n_valid: int,             # positions (row-major) at or past this are padding
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes int32 bits, lens int32) in ``symbols``' shape;
    padding positions get code 0 and length 0."""
    s = symbols.to(torch.int64) & 0xFFFF
    pos = torch.arange(symbols.numel(), device=symbols.device).reshape(symbols.shape)
    valid = pos < n_valid
    return torch.where(valid, enc_codes[s], 0), torch.where(valid, enc_lens[s], 0)


def block_offsets(lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nblocks, B) lengths -> (exclusive in-block bit offsets, block
    totals), int32."""
    inclusive = torch.cumsum(lens, dim=-1, dtype=torch.int32)
    return inclusive - lens, inclusive[..., -1]


def _split_codeword(codes, lens, offsets):
    """Each codeword's parts in the two u32 words it can touch: (word
    index, part OR-ed into it, part OR-ed into the next), parts as int64
    u32 values."""
    c = widen(codes)
    offsets = offsets.to(torch.int64)
    lens = lens.to(torch.int64)
    w = offsets >> 5
    r = (offsets & 31) + lens  # end bit within the 64-bit window at w
    fits = r <= 32
    part1 = torch.where(fits, shl(c, (32 - r).clamp(0, 31)), c >> (r - 32).clamp(0, 31))
    part2 = torch.where(fits, 0, shl(c, (64 - r).clamp(0, 31)))
    zero = lens == 0
    return w, torch.where(zero, 0, part1), torch.where(zero, 0, part2)


def _scatter_words(n_words: int, index: torch.Tensor, parts: list[torch.Tensor]) -> torch.Tensor:
    """Sum ``parts`` into ``n_words`` words at ``index`` and ``index + 1``,
    dropping positions past the end. Returns int32 bits."""
    acc = torch.zeros(n_words + 1, dtype=torch.int64, device=index.device)
    for k, part in enumerate(parts):
        i = index + k
        acc.index_add_(0, torch.where(i < n_words, i, n_words), part)
    return narrow(acc[:n_words])


def pack_blocks(
    codes: torch.Tensor,    # (nblocks, B) int32 bits of right-justified codes
    lens: torch.Tensor,     # (nblocks, B) lengths (0 = padding)
    offsets: torch.Tensor,  # (nblocks, B) in-block bit offsets
    words_per_block: int,
) -> torch.Tensor:
    """(nblocks, words_per_block) int32 slab; a block whose bits exceed its
    row runs into the next row, as in the JAX package."""
    nblocks, _ = codes.shape
    W = words_per_block
    w, part1, part2 = _split_codeword(codes, lens, offsets)
    blk = torch.arange(nblocks, device=codes.device)[:, None]
    flat = (blk * W + w).reshape(-1)
    return _scatter_words(nblocks * W, flat, [part1.reshape(-1), part2.reshape(-1)]).reshape(nblocks, W)


def pack_stream(
    codes: torch.Tensor,         # int32 bits of right-justified codes, any shape
    lens: torch.Tensor,          # lengths, same shape
    offsets_word: torch.Tensor,  # int32 word index of each code's first bit
    offsets_bit: torch.Tensor,   # int32 bit within that word
    total_words: int,
) -> torch.Tensor:
    """One MSB-first stream of ``total_words`` int32 words."""
    w, part1, part2 = _split_codeword(
        codes.reshape(-1), lens.reshape(-1), offsets_bit.reshape(-1)
    )
    w = offsets_word.reshape(-1).to(torch.int64) + w
    return _scatter_words(total_words, w, [part1, part2])
