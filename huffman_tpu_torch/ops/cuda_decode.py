"""Group decode (K1): counterpart of huffman_tpu/ops/pallas_decode.py.

``decode_groups`` runs the lane-parallel canonical decode of interleaved
HTPU v2 group streams: the CUDA kernel in ``csrc/decode.cu`` for CUDA
tensors, ``decode_groups_plain`` for CPU tensors. The output is JAX's
packed layout: ``(ngroups, n_steps/2, 8, 128)`` int32 words, ``[g, h]``
holding steps ``2h`` (low half) and ``2h+1`` (high half) of every lane of
group ``g`` (lane ``s * 128 + l`` at ``[g, h, s, l]``).

In translate mode (alphabets up to ``TRANSLATE_MAX_ALPHABET``) the words
hold symbols, looked up in the kernel's shared-memory table; in rank mode
they hold the canonical ranks' low 16 bits, which
``ops.cuda_gather.gather_u16_pairs`` (K2) turns into symbols. Ranks past the
alphabet (only possible in corrupt streams) read the last symbol, as in
the JAX package's numpy twin
``huffman_tpu.container.interleave.decode_interleaved_numpy``.

``packed_out=False`` gives JAX's unpacked layout instead, ``(ngroups *
n_steps, 8, 128)`` int32 with row ``g * n_steps + t`` holding step ``t``
of group ``g``, one symbol per word; in rank mode the ranks go through
``ops.cuda_gather.gather_u16`` (K5), as the JAX decoder translates them
with ``sym_order_dev``.
"""

from __future__ import annotations

import torch

from ..constants import GROUP_LANES, PRELOAD_WORDS, REFILL_THRESHOLD
from ..runtime import kernels
from ..u32 import MASK32, narrow, shl, widen
from .cuda_gather import gather_u16
from .tables import Tables

# Largest alphabet the decode kernel translates in-kernel (csrc/decode.cu's
# kMaxTranslate): its symbol table, 2 bytes a symbol, lies in shared memory
# beside the stream ring. Measured on the H100 (PERF.md §6, the route
# A/Bs): at 32 MiB, translate beats rank mode + K2 at every alphabet up
# to the full 65,536 symbols, at 32 groups and at 160.
TRANSLATE_MAX_ALPHABET = 65536


def decode_groups(
    streams: torch.Tensor,  # (ngroups, W) int32 bits of u32 stream words
    n_real: torch.Tensor,   # (ngroups,) int32 real lanes per group
    tables: Tables,
    n_steps: int,
    translate: bool,
    packed_out: bool = True,
) -> torch.Tensor:
    """Decode ``n_steps`` symbols in each of the 1024 lanes of every group.
    ``n_steps`` must be even (two steps pack into one output word). Any
    stream width ``W`` works; words past it read as 0.
    ``packed_out=False`` unpacks the pairs and, in rank mode, translates
    the ranks to symbols (see the module docstring)."""
    if n_steps % 2:
        raise ValueError("n_steps (block_symbols) must be even")
    if streams.dim() != 2 or n_real.shape != (streams.shape[0],):
        raise ValueError("streams must be (ngroups, W) and n_real (ngroups,)")
    dev = streams.device
    kernels.check(streams, torch.int32, dev, "streams")
    kernels.check(n_real, torch.int32, dev, "n_real")
    kernels.check(tables.lj_limit, torch.int32, dev, "lj_limit")
    kernels.check(tables.base, torch.int32, dev, "base")
    kernels.check(tables.sym_order, torch.int16, dev, "sym_order")
    n_sym = tables.sym_order.numel()
    if translate and not 1 <= n_sym <= TRANSLATE_MAX_ALPHABET:
        raise ValueError(
            f"translate mode needs 1..{TRANSLATE_MAX_ALPHABET} symbols, got {n_sym}"
        )
    ngroups, width = streams.shape
    if dev.type == "cuda":
        out = torch.empty(
            (ngroups, n_steps // 2, 8, 128), dtype=torch.int32, device=dev
        )
        kernels.launch(
            "decode_groups", streams.data_ptr(), width, n_real.data_ptr(),
            ngroups, tables.lj_limit.data_ptr(), tables.base.data_ptr(),
            tables.sym_order.data_ptr(), n_sym, int(translate), n_steps,
            tables.min_len, tables.max_len, out.data_ptr(),
        )
    elif dev.type == "cpu":
        out = decode_groups_plain(streams, n_real, tables, n_steps, translate)
    else:
        raise ValueError(f"decode_groups: unsupported device {dev}")
    if packed_out:
        return out
    # (g, h, 8, 128) pairs -> (g, h, 2, 8, 128): step 2h is the low half.
    steps = torch.stack([out & 0xFFFF, (out >> 16) & 0xFFFF], dim=2)
    steps = steps.reshape(ngroups * n_steps, 8, 128)
    return steps if translate else gather_u16(steps, tables.sym_order)


def decode_groups_plain(
    streams: torch.Tensor,
    n_real: torch.Tensor,
    tables: Tables,
    n_steps: int,
    translate: bool,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel: the numpy twin
    ``decode_interleaved_numpy`` as vector ops over all lanes of all
    groups, one Python iteration per step."""
    ngroups, width = streams.shape
    dev = streams.device
    L = GROUP_LANES
    min_w = PRELOAD_WORDS * L
    words = widen(streams)
    if width < min_w:
        words = torch.nn.functional.pad(words, (0, min_w - width))
        width = min_w
    lane = torch.arange(L, device=dev)
    bits = torch.where(
        lane[None, :] < n_real.to(torch.int64)[:, None], 64, 1 << 30
    ).to(torch.int64)
    bufA = words[:, :L].clone()
    bufB = words[:, L : 2 * L].clone()
    head = torch.full((ngroups,), min_w, dtype=torch.int64, device=dev)
    lj = widen(tables.lj_limit)[tables.min_len - 1 : tables.max_len - 1]
    base = widen(tables.base)
    sym = tables.sym_order.to(torch.int64) & 0xFFFF
    last = max(sym.numel() - 1, 0)
    out = torch.empty((ngroups, n_steps // 2, L), dtype=torch.int64, device=dev)
    lo = None
    for t in range(n_steps):
        peek = bufA
        length = tables.min_len + (peek[..., None] >= lj).sum(-1)
        rank = (base[length] + (peek >> (32 - length))) & MASK32
        s = sym[rank.clamp(max=last)] if translate else rank & 0xFFFF
        if t % 2 == 0:
            lo = s
        else:
            out[:, t // 2] = lo | (s << 16)

        full = length == 32
        bufA = torch.where(full, bufB, shl(bufA, length) | (bufB >> ((32 - length) & 31)))
        bufB = torch.where(full, 0, shl(bufB, length))
        bits = bits - length

        need = bits < REFILL_THRESHOLD
        n_i = need.to(torch.int64)
        slot = head[:, None] + torch.cumsum(n_i, dim=1) - n_i
        word = torch.where(
            slot < width, words.gather(1, slot.clamp(max=width - 1)), 0
        )
        bpos = bits.clamp(1, 32)  # refilling lanes hold 1..32 bits
        bufA = torch.where(need, bufA | (word >> bpos), bufA)
        bufB = torch.where(need, bufB | shl(word, 32 - bpos), bufB)
        bits = torch.where(need, bits + 32, bits)
        head = head + n_i.sum(dim=1)
    return narrow(out).reshape(ngroups, n_steps // 2, 8, 128)
