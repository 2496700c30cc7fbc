"""Lane-parallel canonical decode of per-block streams (the v1 container's
slabs): counterpart of huffman_tpu/ops/decode.py, an XLA loop in the JAX
package, so a Python loop of tensor ops here.

Each step decodes one symbol in every block: the 32-bit peek at the
block's bit cursor, ``len = min(1 + #(peek >= lj_limit), max_len)``, ``rank
= base[len] + (peek >> (32 - len))`` mod 2**32, one table read, and the
cursor moves on by ``len``. Blocks decode ``n_steps`` symbols whatever
their length; the container trims the garbage past each block's data.
Out-of-range reads clamp exactly as XLA's ``mode="clip"`` does in the JAX
function, so whole outputs agree, garbage steps included: word indices
clamp into the row, and a rank is read as int32 (negative past 2**31, so
index 0) and clamped into the table.
"""

from __future__ import annotations

import torch

from ..u32 import MASK32, shl, widen


def decode_blocks(
    slab: torch.Tensor,       # (nblocks, W) int32 bits, each row an MSB-first stream
    lj_limit: torch.Tensor,   # (MAX_CODE_LEN,) int32 bits
    base: torch.Tensor,       # (MAX_CODE_LEN + 1,) int32 bits, wrapped mod 2^32
    sym_order: torch.Tensor,  # (n,) canonical symbol order (int16 bits or int32)
    n_steps: int,             # symbols per block
    max_len: int,             # the codebook's longest code (>= 1)
) -> torch.Tensor:
    """Every block's first ``n_steps`` symbols: (nblocks, n_steps) int32."""
    nblocks, W = slab.shape
    dev = slab.device
    words = widen(slab)
    lj = widen(lj_limit)
    base = widen(base)
    table = sym_order.to(torch.int64) & 0xFFFF
    last = table.numel() - 1
    pos = torch.zeros((nblocks, 1), dtype=torch.int64, device=dev)
    out = torch.empty((nblocks, n_steps), dtype=torch.int32, device=dev)
    for t in range(n_steps):
        w = pos >> 5
        sh = pos & 31
        hi = words.gather(1, w.clamp(0, W - 1))
        lo = words.gather(1, (w + 1).clamp(0, W - 1))
        peek = shl(hi, sh) | torch.where(sh > 0, lo >> ((32 - sh) & 31), 0)
        length = (1 + (peek >= lj).sum(dim=1, keepdim=True)).clamp(max=max_len)
        rank = (base[length] + (peek >> (32 - length))) & MASK32
        idx = torch.where(rank >= 1 << 31, 0, rank.clamp(max=last))
        out[:, t] = table[idx[:, 0]].to(torch.int32)
        pos = pos + length
    return out
