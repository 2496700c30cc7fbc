"""Table lookups (K2, K3, K5, K8, K9): counterpart of
huffman_tpu/ops/pallas_gather.py.

* ``gather_u16_pairs`` (K2): both 16-bit halves of each packed rank word
  index the canonical symbol table, giving packed symbol pairs: the
  decoder's rank mode. Indices past the table read its last entry.
* ``gather_u16`` (K5): one int32 index per element, clamped into the
  16-bit table: the unpacked rank-mode decode output (``decode_groups``
  with ``packed_out=False``) to symbols, as ``gather_u16_pallas``.
* ``gather_codes`` (K3): symbol -> (code, length) through the dense
  ``len << 26 | code`` table, with the encoder's valid mask applied. The
  TPU needed two kernels for this one function (a row-displacement table
  and a packed-16 dense table); on the GPU the dense table is enough.
  ``gather_table_codes`` takes a codebook's ``Tables`` and uses K3, or
  the two-table gather of ``ops/encode.py`` when the codes are deeper
  than the word's 26 bits.
* ``build_rank_select`` (tensor ops): the succinct dictionary of the fused
  encoder, presence mask words, their exclusive counts, and a dense
  rank-ordered payload table.
* ``gather_rank_select`` (K8): symbol -> (code, length) through that
  dictionary, payload ``len << 26 | code``.
* ``gather_rank_canonical`` (K9): symbol -> canonical rank (through the
  dictionary, or the symbol itself at the full-alphabet tier) -> length by
  compares against the class starts, code = rank - base[len] mod 2^32.

K8 and K9, like K3, read the byte view as u16 symbols and give code 0,
length 0 at positions at or past ``n_valid``. Each wrapper launches its
CUDA kernel (``csrc/gather.cu``, ``csrc/rank_gather.cu``) for CUDA tensors
and its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..constants import MAX_CODE_LEN, MAX_SYMBOLS
from ..runtime import kernels
from ..u32 import MASK32, narrow, popcount32, widen
from . import encode as enc
from .tables import PACKED_MAX_LEN, Tables

CODE_MASK = (1 << 26) - 1
RANK_WORDS = MAX_SYMBOLS // 32  # presence mask words of the rank stage
MAX_RANK_TABLE = 32768          # words of a rank gather's table in shared memory


def gather_u16_pairs(packed_idx: torch.Tensor, sym_order: torch.Tensor) -> torch.Tensor:
    """``packed_idx``: int32 words ``lo | hi << 16`` of any shape;
    ``sym_order``: (n,) int16 bits of the u16 table, n >= 1. Returns int32
    words ``table[lo] | table[hi] << 16`` in ``packed_idx``'s shape."""
    dev = packed_idx.device
    kernels.check(packed_idx, torch.int32, dev, "packed_idx")
    kernels.check(sym_order, torch.int16, dev, "sym_order")
    if sym_order.numel() < 1:
        raise ValueError("gather_u16_pairs needs a non-empty table")
    if dev.type == "cuda":
        out = torch.empty_like(packed_idx)
        kernels.launch(
            "gather_u16_pairs", packed_idx.data_ptr(), packed_idx.numel(),
            sym_order.data_ptr(), sym_order.numel(), out.data_ptr(),
        )
        return out
    if dev.type == "cpu":
        return gather_u16_pairs_plain(packed_idx, sym_order)
    raise ValueError(f"gather_u16_pairs: unsupported device {dev}")


def gather_u16_pairs_plain(packed_idx: torch.Tensor, sym_order: torch.Tensor) -> torch.Tensor:
    u = widen(packed_idx)
    table = sym_order.to(torch.int64) & 0xFFFF
    last = table.numel() - 1
    lo = table[(u & 0xFFFF).clamp(max=last)]
    hi = table[(u >> 16).clamp(max=last)]
    return narrow(lo | (hi << 16))


def gather_u16(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``idx``: int32 of any shape; ``table``: (n,) int16 bits of the u16
    table, n >= 1. Returns int32 ``table[clamp(idx, 0, n - 1)]``
    (zero-extended) in ``idx``'s shape."""
    dev = idx.device
    kernels.check(idx, torch.int32, dev, "idx")
    kernels.check(table, torch.int16, dev, "table")
    if not 1 <= table.numel() <= MAX_SYMBOLS:
        raise ValueError(f"gather_u16 needs a table of 1..{MAX_SYMBOLS} entries")
    if dev.type == "cuda":
        out = torch.empty_like(idx)
        kernels.launch(
            "gather_u16", idx.data_ptr(), idx.numel(), table.data_ptr(),
            table.numel(), out.data_ptr(),
        )
        return out
    if dev.type == "cpu":
        return gather_u16_plain(idx, table)
    raise ValueError(f"gather_u16: unsupported device {dev}")


def gather_u16_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    values = table.to(torch.int32) & 0xFFFF
    return values[idx.to(torch.int64).clamp(0, values.numel() - 1)]


def gather_codes(
    symbols: torch.Tensor,  # int16 bits of u16 symbols, any shape
    table: torch.Tensor,    # (65536,) int32 bits of len << 26 | code
    n_valid: int,           # positions (row-major) at or past this are padding
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes int32, lens int32) in ``symbols``' shape; padding
    positions get code 0 and length 0."""
    dev = symbols.device
    kernels.check(symbols, torch.int16, dev, "symbols")
    kernels.check(table, torch.int32, dev, "table")
    if table.numel() != 1 << 16:
        raise ValueError("gather_codes needs the dense 65,536-entry table")
    if dev.type == "cuda":
        codes = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        lens = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        kernels.launch(
            "gather_codes", symbols.data_ptr(), symbols.numel(), n_valid,
            table.data_ptr(), codes.data_ptr(), lens.data_ptr(),
        )
        return codes, lens
    if dev.type == "cpu":
        return gather_codes_plain(symbols, table, n_valid)
    raise ValueError(f"gather_codes: unsupported device {dev}")


def gather_table_codes(
    symbols: torch.Tensor, tables: Tables, n_valid: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, lens) of ``symbols`` through a host codebook's tables."""
    if tables.enc_packed is not None:
        return gather_codes(symbols, tables.enc_packed, n_valid)
    return enc.gather_codes(symbols, tables.enc_codes, tables.enc_lens, n_valid)


def gather_codes_plain(
    symbols: torch.Tensor, table: torch.Tensor, n_valid: int
) -> tuple[torch.Tensor, torch.Tensor]:
    return _split(widen(table)[symbols.to(torch.int64) & 0xFFFF], symbols, n_valid)


def build_rank_select(
    values: torch.Tensor,   # (65536,) int32 bits of the u32 payload per symbol
    present: torch.Tensor,  # (65536,) bool
    cap: int,               # dense table entries; the alphabet must fit
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(maskwords (2048,) int32 bits, cums (2048,) int32 exclusive counts,
    dense (cap,) int32 bits): the contract of ``build_rank_select`` for
    alphabets of at most ``cap`` symbols (the caller picks the tier from
    the alphabet size, so the JAX package's overflow flag is not needed)."""
    p = present.reshape(RANK_WORDS, 32).to(torch.int64)
    bit = torch.arange(32, device=present.device)
    maskwords = narrow((p << bit).sum(dim=1))
    counts = p.sum(dim=1)
    cums = (torch.cumsum(counts, dim=0) - counts).to(torch.int32)
    pres = present.to(torch.int64)
    rank = torch.cumsum(pres, dim=0) - pres
    dense = torch.zeros(cap, dtype=torch.int64, device=present.device)
    dense.scatter_add_(0, rank.clamp(max=cap - 1), torch.where(present, widen(values), 0))
    return maskwords, cums, narrow(dense)


def _check_rank_tables(symbols, maskwords, cums, table):
    dev = symbols.device
    kernels.check(symbols, torch.int16, dev, "symbols")
    kernels.check(maskwords, torch.int32, dev, "maskwords")
    kernels.check(cums, torch.int32, dev, "cums")
    kernels.check(table, torch.int32, dev, "table")
    if maskwords.shape != (RANK_WORDS,) or cums.shape != (RANK_WORDS,):
        raise ValueError(f"maskwords and cums must be ({RANK_WORDS},)")
    if table.dim() != 1 or not 1 <= table.numel() <= MAX_RANK_TABLE:
        raise ValueError(f"the rank table must be (1..{MAX_RANK_TABLE},)")
    return dev


def _select_rank(s, maskwords, cums):
    w = s >> 5
    below = (1 << (s & 31)) - 1
    return cums.to(torch.int64)[w] + popcount32(widen(maskwords)[w] & below)


def _split(packed, symbols, n_valid):
    pos = torch.arange(symbols.numel(), device=symbols.device).reshape(symbols.shape)
    packed = torch.where(pos < n_valid, packed, 0)
    return (packed & CODE_MASK).to(torch.int32), (packed >> 26).to(torch.int32)


def gather_rank_select(
    symbols: torch.Tensor,    # int16 bits of u16 symbols, any shape
    n_valid: int,             # positions (row-major) at or past this are padding
    maskwords: torch.Tensor,  # (2048,) int32 bits
    cums: torch.Tensor,       # (2048,) int32
    dense: torch.Tensor,      # (cap,) int32 bits of len << 26 | code
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes int32, lens int32) in ``symbols``' shape. Valid only
    for symbols present in the build (the codebook comes from the data's
    own histogram, so others cannot occur before ``n_valid``)."""
    dev = _check_rank_tables(symbols, maskwords, cums, dense)
    if dev.type == "cuda":
        codes = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        lens = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        kernels.launch(
            "gather_rank_select", symbols.data_ptr(), symbols.numel(), n_valid,
            maskwords.data_ptr(), cums.data_ptr(), dense.data_ptr(),
            dense.numel(), codes.data_ptr(), lens.data_ptr(),
        )
        return codes, lens
    if dev.type == "cpu":
        return gather_rank_select_plain(symbols, n_valid, maskwords, cums, dense)
    raise ValueError(f"gather_rank_select: unsupported device {dev}")


def gather_rank_select_plain(symbols, n_valid, maskwords, cums, dense):
    s = symbols.to(torch.int64) & 0xFFFF
    rank = _select_rank(s, maskwords, cums).clamp(0, dense.numel() - 1)
    return _split(widen(dense)[rank], symbols, n_valid)


def gather_rank_canonical(
    symbols: torch.Tensor,    # int16 bits of u16 symbols, any shape
    n_valid: int,
    maskwords: torch.Tensor,  # (2048,) int32 bits (unread when identity_rank)
    cums: torch.Tensor,       # (2048,) int32 (unread when identity_rank)
    canon16: torch.Tensor,    # (cap / 2,) int32 bits of packed-16 canonical ranks
    start: torch.Tensor,      # (33,) int32: #codes with length < l
    base: torch.Tensor,       # (33,) int32 bits of the decode base table
    max_len: int,
    identity_rank: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes int32, lens int32) in ``symbols``' shape.
    ``identity_rank``: canon16 packs the canonical rank of every one of the
    65,536 symbols, addressed by the symbol itself."""
    dev = _check_rank_tables(symbols, maskwords, cums, canon16)
    kernels.check(start, torch.int32, dev, "start")
    kernels.check(base, torch.int32, dev, "base")
    if start.shape != (MAX_CODE_LEN + 1,) or base.shape != (MAX_CODE_LEN + 1,):
        raise ValueError(f"start and base must be ({MAX_CODE_LEN + 1},)")
    if not 1 <= max_len <= PACKED_MAX_LEN:
        raise ValueError(f"max_len={max_len} outside [1, {PACKED_MAX_LEN}]")
    if identity_rank and canon16.numel() != MAX_SYMBOLS // 2:
        raise ValueError("identity_rank needs the full 65,536-symbol table")
    if dev.type == "cuda":
        codes = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        lens = torch.empty(symbols.shape, dtype=torch.int32, device=dev)
        kernels.launch(
            "gather_rank_canonical", symbols.data_ptr(), symbols.numel(),
            n_valid, maskwords.data_ptr(), cums.data_ptr(), canon16.data_ptr(),
            canon16.numel(), start.data_ptr(), base.data_ptr(), max_len,
            int(identity_rank), codes.data_ptr(), lens.data_ptr(),
        )
        return codes, lens
    if dev.type == "cpu":
        return gather_rank_canonical_plain(
            symbols, n_valid, maskwords, cums, canon16, start, base, max_len,
            identity_rank,
        )
    raise ValueError(f"gather_rank_canonical: unsupported device {dev}")


def gather_rank_canonical_plain(
    symbols, n_valid, maskwords, cums, canon16, start, base, max_len, identity_rank
):
    s = symbols.to(torch.int64) & 0xFFFF
    rank = s if identity_rank else _select_rank(s, maskwords, cums)
    pair = widen(canon16)[(rank >> 1).clamp(0, canon16.numel() - 1)]
    canon = (pair >> ((rank & 1) << 4)) & 0xFFFF
    length = torch.ones_like(canon)
    for l in range(2, max_len + 1):
        length += canon >= start[l]
    code = (canon - widen(base)[length]) & MASK32
    return _split(((length << 26) | code) & MASK32, symbols, n_valid)
