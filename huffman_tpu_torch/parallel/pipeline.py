"""Distributed compression pipeline on ``torch.distributed``: counterpart
of huffman_tpu/parallel/pipeline.py.

The JAX module is SPMD: ``shard_map`` over a 1-D device mesh. Here each
rank is a process, and a process group (default: the world) takes the
mesh's place. Every function takes the rank's local shard, tensors on the
rank's device, and returns the rank's local outputs and the replicated
ones, as the JAX function's ``out_specs`` split them. ``shard(t)`` cuts a
rank's contiguous share out of a whole tensor, as the mesh's
``PartitionSpec`` does; shards are the same size on every rank.

* **histogram**: each rank histograms its shard (K6 on the card), then
  ``all_reduce(SUM)`` of the (65536,) int32 counts (the JAX ``psum``);
* **encode**: the v1 route's code gather (K3) and per-block pack (K4) on
  the local blocks; block bit counts are ``all_gather``-ed in rank order;
* **fused encode** (``distributed_encode_streams``): the fused device
  encode split at its histogram: local K6 on the rank's valid prefix,
  ``all_reduce``, then the package-merge codebook and rank gather on the
  replicated histogram (K7, K8/K9) and the lane pack (K4) of the local
  lanes; group word counts are ``all_gather``-ed;
* **decode**: local, no collective (``decode_blocks`` for v1 slabs, K1
  with K2 or K5 for v2 groups).

A collective runs on the group's backend: gloo takes CPU tensors, NCCL
CUDA ones. A function given tensors on a device its group's backend
cannot take raises ``ValueError``; nothing is copied through the host.
Every check that can fail on one rank alone runs before the first
collective, so that no rank is left waiting in one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..constants import GROUP_LANES
from ..ops.cuda_decode import decode_groups
from ..ops.cuda_encode import pack_blocks
from ..ops.cuda_gather import gather_table_codes, gather_u16_pairs
from ..ops.cuda_hist import histogram
from ..ops.decode import decode_blocks
from ..ops.fused import encode_from_histogram
from ..ops.tables import Tables

_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


def _check_device(group, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``group``'s backend takes tensors on
    ``t``'s device. A backend string may name one backend per device
    type ("cpu:gloo,cuda:nccl")."""
    backend = str(dist.get_backend(group))
    takes = {_BACKEND_DEVICE.get(b.split(":")[-1]) for b in backend.split(",")}
    if t.device.type not in takes:
        raise ValueError(
            f"process group backend {backend!r} cannot take tensors on {t.device}"
        )


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` concatenated along dim 0, in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _local_valid(t: torch.Tensor, n_pairs: int, group) -> int:
    """Valid symbols of the rank's shard ``t`` of a row-major whole whose
    first ``n_pairs`` symbols are real. The shards must be the same size
    on every rank (``shard_map``'s guarantee in the JAX package), which
    one ``all_gather`` of the sizes checks; every rank sees the same sizes
    and raises together."""
    n = t.numel()
    sizes = _all_gather(torch.tensor([n], dtype=torch.int64, device=t.device), group)
    if (sizes != n).any():
        raise ValueError(f"shards differ in size across ranks: {sizes.tolist()}")
    return min(max(n_pairs - dist.get_rank(group) * n, 0), n)


def shard(t: torch.Tensor, group=None) -> torch.Tensor:
    """The rank's contiguous share of ``t`` along dim 0 (a view). Raises
    ``ValueError`` when dim 0 does not split evenly over the ranks, as a
    mesh axis that does not divide an array cannot shard it."""
    world = dist.get_world_size(group)
    if t.shape[0] % world:
        raise ValueError(
            f"{t.shape[0]} rows (blocks, lanes or groups) do not split evenly "
            f"over {world} ranks"
        )
    per = t.shape[0] // world
    rank = dist.get_rank(group)
    return t[rank * per : (rank + 1) * per]


def distributed_histogram(symbols: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduced dense histogram. ``symbols``: the rank's symbols, int16
    bits of u16, any shape and length. Returns the (65536,) int32
    histogram of every rank's symbols, replicated."""
    _check_device(group, symbols)
    hist = histogram(symbols, symbols.numel())
    dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=group)
    return hist


def distributed_encode(
    symbols: torch.Tensor,  # (nblocks_loc, B) int16 bits: the rank's blocks
    n_pairs: int,           # real symbols of the whole (row-major); the rest pad
    tables: Tables,         # the codebook's tables, on the rank's device
    words_per_block: int,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each rank packs its blocks; block bit counts are all-gathered (the
    collective that orders container assembly). Returns (the rank's
    (nblocks_loc, words_per_block) int32 slab, every block's bit count
    (nblocks,) int32, replicated)."""
    _check_device(group, symbols)
    n_valid = _local_valid(symbols, n_pairs, group)
    codes, lens = gather_table_codes(symbols, tables, n_valid)
    slab = pack_blocks(codes, lens, words_per_block)
    return slab, _all_gather(lens.sum(dim=1, dtype=torch.int32), group)


def distributed_decode(
    slab: torch.Tensor,  # (nblocks_loc, W) int32 bits: the rank's blocks
    tables: Tables,
    n_steps: int,
    group=None,
) -> torch.Tensor:
    """Block-parallel lane decode of the rank's slab (``decode_blocks``);
    no collective. Returns (nblocks_loc, n_steps) int32 symbols."""
    _check_device(group, slab)
    return decode_blocks(
        slab, tables.lj_limit, tables.base, tables.sym_order, n_steps, tables.max_len
    )


def distributed_decode_groups(
    streams: torch.Tensor,  # (ngroups_loc, W) int32 bits: the rank's groups
    n_real: torch.Tensor,   # (ngroups_loc,) int32 real lanes per group
    tables: Tables,
    n_steps: int,
    translate: bool,
    packed_out: bool = True,
    group=None,
) -> torch.Tensor:
    """The group decoder (K1) on the rank's groups; groups are the unit of
    parallelism, so no collective. ``translate=False`` is the rank mode of
    wide alphabets, translated to symbols with ``tables.sym_order``: K2 on
    the packed pairs, or K5 with ``packed_out=False``. Returns symbols in
    ``ops.cuda_decode.decode_groups``' layouts: (ngroups_loc, n_steps/2,
    8, 128) packed pairs, or (ngroups_loc * n_steps, 8, 128) unpacked. The
    JAX function needs the group count to divide by the mesh size;
    ``shard`` raises ``ValueError`` where it does not."""
    _check_device(group, streams)
    out = decode_groups(streams, n_real, tables, n_steps, translate, packed_out)
    if translate or not packed_out:
        return out
    return gather_u16_pairs(out, tables.sym_order)


def compress_decompress_step(
    symbols: torch.Tensor,  # (nblocks_loc, B) int16 bits: the rank's blocks
    n_pairs: int,           # real symbols of the whole (row-major)
    tables: Tables,
    words_per_block: int,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full distributed step: histogram with ``all_reduce``, encode,
    decode, a correctness ``all_reduce(MIN)``, and block bits by
    ``all_gather``. Returns (histogram (65536,) int32, replicated; the
    rank's slab; block bits (nblocks,) int32, replicated; ok, a 0-dim
    int32 that is 1 when every rank decoded its valid symbols back)."""
    _check_device(group, symbols)
    n_valid = _local_valid(symbols, n_pairs, group)
    hist = histogram(symbols, n_valid)
    dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=group)
    codes, lens = gather_table_codes(symbols, tables, n_valid)
    slab = pack_blocks(codes, lens, words_per_block)
    decoded = decode_blocks(
        slab, tables.lj_limit, tables.base, tables.sym_order, symbols.shape[1],
        tables.max_len,
    )
    pos = torch.arange(symbols.numel(), device=symbols.device).reshape(symbols.shape)
    same = decoded == (symbols.to(torch.int32) & 0xFFFF)
    ok = torch.where(pos < n_valid, same, True).all().to(torch.int32).reshape(1)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    bits = _all_gather(lens.sum(dim=1, dtype=torch.int32), group)
    return hist, slab, bits, ok[0]


def distributed_encode_streams(
    symbols: torch.Tensor,  # (n_lanes_loc, B) int16 bits: the rank's lanes
    n_pairs: int,           # real symbols of the whole (row-major)
    max_len: int = 18,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused encode, distributed: the local histogram of the rank's
    valid prefix (K6) and its ``all_reduce``, the codebook and gather at
    the replicated histogram's alphabet tier (K7, K8/K9), the lane pack
    and stream assembly of the rank's groups (K4), and the group word
    counts by ``all_gather``. Lanes per rank must be a multiple of
    GROUP_LANES.

    Returns (the rank's streams (ngroups_loc, 2048 + cap) int32 bits,
    every group's word count (ngroups,) int32, replicated; the code
    lengths (65536,) int32, replicated; ok, a 0-dim bool). The stream
    buffer's width ``cap`` is sized from the rank's data, as
    ``fused.encode_device`` sizes it, so no ``words_cap`` is taken; the
    port picks the exact alphabet tier, so ``ok`` is always true (the
    JAX ``alphabet_cap`` is not ported)."""
    _check_device(group, symbols)
    n_valid = _local_valid(symbols, n_pairs, group)
    if symbols.dim() != 2 or symbols.shape[0] % GROUP_LANES:
        raise ValueError("n_lanes must split into whole GROUP_LANES groups per rank")
    hist = histogram(symbols, n_valid)
    dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=group)
    r = encode_from_histogram(symbols, n_valid, hist, max_len)
    counts = _all_gather(r["counts"].to(torch.int32), group)
    ok = torch.ones((), dtype=torch.bool, device=symbols.device)
    return r["streams"], counts, r["lengths"], ok
