"""Sharded archive ("HTPX"): counterpart of
huffman_tpu/container/sharded.py, with ``device`` in place of ``backend``
and a ``torch.distributed`` process group in place of the JAX mesh.

The input splits into pair-aligned byte shards, each compressed to an
inner HTPU container (independently decodable), and a thin outer index
stitches them together:

    offset  size  field
    0       4     magic "HTPX"
    4       1     version (1)
    5       1     codebook mode (0 = per-shard, 1 = global)
    6       2     reserved
    8       4     shard count (u32)
    12      8     original size (u64)
    [global mode only]
    .       4     codebook blob size (u32)
    .       .     codebook: u32[32] counts-per-length ++ u16[n] symbols
    then    8*n   inner container byte lengths (u64[n])
    ...           inner HTPU containers, back to back

Codebook modes:
* per-shard: each shard builds its own codebook (shards of
  ``DEVICE_MIN_PAIRS`` symbols or more take the fused device route);
* global: ONE codebook from the full-corpus histogram, stored once at the
  archive level; the inner containers leave it out and take the
  host-codebook route. With ``group=`` the histogram is all-reduced over
  the group's ranks (``parallel.pipeline.distributed_histogram``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..constants import DEFAULT_MAX_CODE_LEN
from ..device import resolve_device
from ..parallel.pipeline import distributed_histogram
from . import HTPX_MAGIC, block_format
from .reference_format import bytes_to_symbols, histogram_host

MAGIC = HTPX_MAGIC
_HDR = 20


def _shard_ranges(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Pair-aligned contiguous byte ranges covering [0, n)."""
    per = (n // n_shards + 1) & ~1  # even split, pair-aligned
    out = []
    start = 0
    for _ in range(n_shards):
        end = min(start + per, n)
        out.append((start, end))
        start = end
    out[-1] = (out[-1][0], n)
    return out


def _group_histogram(symbols: np.ndarray, group, device: torch.device) -> np.ndarray:
    """The histogram of ``symbols`` (every rank passes all of them): rank
    r counts its r-th contiguous slice on ``device``, and the counts are
    all-reduced over ``group``."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n = symbols.size
    mine = np.ascontiguousarray(symbols[rank * n // world : (rank + 1) * n // world])
    local = torch.from_numpy(mine.view(np.int16)).to(device)
    return distributed_histogram(local, group).cpu().numpy().astype(np.int64)


def compress(
    data: bytes,
    n_shards: int = 1,
    codebook_mode: str = "global",
    group=None,
    device: str | torch.device = "cuda",
    **kwargs,
) -> bytes:
    """Compress to a sharded HTPX archive; ``kwargs`` go to
    ``block_format.compress`` for every shard.

    ``group`` (a ``torch.distributed`` process group, or the default
    group's ``dist.group.WORLD``): with codebook_mode="global", every rank
    passes the whole ``data``, each histograms its slice on ``device``,
    and the counts are all-reduced. The archive equals the one built
    without a group, byte for byte."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    dev = resolve_device(device)
    ranges = _shard_ranges(len(data), n_shards)

    codebook = None
    mode_flag = 0
    if codebook_mode == "global":
        mode_flag = 1
        symbols, _, _ = bytes_to_symbols(data)
        if group is not None:
            hist = _group_histogram(symbols, group, dev)
        else:
            hist = histogram_host(symbols)
        # The last shard may own an odd tail byte; it is stored raw and
        # never histogrammed, so the global histogram is exact.
        codebook = block_format._host_codebook(
            hist, kwargs.get("max_code_len", DEFAULT_MAX_CODE_LEN)
        )
    elif codebook_mode != "per-shard":
        raise ValueError(f"unknown codebook_mode {codebook_mode!r}")

    inners = [
        block_format.compress(
            data[a:b], dev, codebook=codebook,
            embed_codebook=codebook is None, **kwargs
        )
        for a, b in ranges
    ]

    out = bytearray(_HDR)
    out[0:4] = int(MAGIC).to_bytes(4, "little")
    out[4] = 1
    out[5] = mode_flag
    out[8:12] = len(inners).to_bytes(4, "little")
    out[12:20] = len(data).to_bytes(8, "little")
    if codebook is not None:
        cb_blob = block_format._codebook_to_header(codebook)
        out += len(cb_blob).to_bytes(4, "little")
        out += cb_blob
    for blob in inners:
        out += len(blob).to_bytes(8, "little")
    for blob in inners:
        out += blob
    return bytes(out)


def decompress(blob: bytes, device: str | torch.device = "cuda") -> bytes:
    dev = resolve_device(device)
    if len(blob) < _HDR or int.from_bytes(blob[0:4], "little") != MAGIC:
        raise ValueError("not an HTPX archive")
    if blob[4] != 1:
        raise ValueError(f"unsupported HTPX version {blob[4]}")
    n_shards = int.from_bytes(blob[8:12], "little")
    original = int.from_bytes(blob[12:20], "little")
    off = _HDR
    codebook = None
    if blob[5] == 1:  # global mode: one codebook for every shard
        if off + 4 > len(blob):
            raise ValueError("truncated HTPX codebook")
        cb_size = int.from_bytes(blob[off : off + 4], "little")
        off += 4
        if off + cb_size > len(blob):
            raise ValueError("truncated HTPX codebook")
        codebook = block_format.codebook_from_blob(blob[off : off + cb_size])
        off += cb_size
    sizes = []
    for _ in range(n_shards):
        if off + 8 > len(blob):
            raise ValueError("truncated HTPX index")
        sizes.append(int.from_bytes(blob[off : off + 8], "little"))
        off += 8
    parts = []
    for s in sizes:
        if off + s > len(blob):
            raise ValueError("truncated HTPX shard")
        parts.append(
            block_format.decompress(blob[off : off + s], dev, codebook=codebook)
        )
        off += s
    out = b"".join(parts)
    if len(out) != original:
        raise ValueError("HTPX size mismatch after decompression")
    return out
