"""Device-resident codebook tables (counterpart of huffman_tpu/ops/tables.py).

This module turns the numpy fields of the port's host ``Codebook``
(``huffman_tpu_torch.codebook``) into the tensors the kernels read. u32
values travel as int32 bit patterns; ``base`` is wrapped mod 2**32, which
keeps rank arithmetic exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..codebook import Codebook
from ..constants import MAX_CODE_LEN, MAX_SYMBOLS
from ..u32 import from_numpy_u32
from ..utils.profiling import copied

# Codes of up to this many bits share a word with their 6-bit length in
# the dense encode table (len << 26 | code).
PACKED_MAX_LEN = 26


class Tables(NamedTuple):
    lj_limit: torch.Tensor   # (MAX_CODE_LEN,) int32 bits of u32 boundaries
    base: torch.Tensor       # (MAX_CODE_LEN + 1,) int32 bits, wrapped mod 2^32
    sym_order: torch.Tensor  # (n_unique,) int16 bits of the u16 symbols
    enc_packed: torch.Tensor | None  # (MAX_SYMBOLS,) int32 bits of len<<26|code;
                                     # None when max_len > PACKED_MAX_LEN
    enc_codes: torch.Tensor  # (MAX_SYMBOLS,) int32 bits of the u32 codes
    enc_lens: torch.Tensor   # (MAX_SYMBOLS,) int32 code lengths (0 absent)
    min_len: int             # shortest code length present (1 if none)
    max_len: int             # longest code length present (1 if none)


def tables_from_numpy(
    lengths: np.ndarray,    # (MAX_SYMBOLS,) u8 code length per symbol
    codes: np.ndarray,      # (MAX_SYMBOLS,) u32 right-justified codewords
    lj_limit: np.ndarray,   # (MAX_CODE_LEN,) u32
    base: np.ndarray,       # (MAX_CODE_LEN + 1,) int64
    sym_order: np.ndarray,  # (n_unique,) u16
    device: torch.device,
) -> Tables:
    lengths = np.asarray(lengths, dtype=np.uint8)
    if lengths.shape != (MAX_SYMBOLS,) or np.shape(lj_limit) != (MAX_CODE_LEN,):
        raise ValueError("expected dense MAX_SYMBOLS / MAX_CODE_LEN tables")
    present = lengths[lengths > 0]
    max_len = max(int(present.max(initial=0)), 1)
    enc = None
    if max_len <= PACKED_MAX_LEN:
        enc = from_numpy_u32(
            (lengths.astype(np.uint32) << 26) | np.asarray(codes, np.uint32),
            device,
        )
    so = torch.from_numpy(
        np.ascontiguousarray(np.asarray(sym_order, dtype=np.uint16)).view(np.int16).copy())
    lens = torch.from_numpy(lengths.astype(np.int32))
    return Tables(
        lj_limit=from_numpy_u32(lj_limit, device),
        base=from_numpy_u32(np.asarray(base, np.int64) & 0xFFFFFFFF, device),
        sym_order=copied(so, so.to(device)),
        enc_packed=enc,
        enc_codes=from_numpy_u32(codes, device),
        enc_lens=copied(lens, lens.to(device)),
        min_len=min(int(present.min()) if present.size else 1, max_len),
        max_len=max_len,
    )


def tables_from_codebook(cb: Codebook, device: torch.device) -> Tables:
    return tables_from_numpy(
        cb.lengths, cb.codes, cb.lj_limit, cb.base, cb.sym_order, device
    )
