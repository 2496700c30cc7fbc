#!/usr/bin/env python3
"""Bytes the port's distribution layer (huffman_tpu_torch/parallel/
pipeline.py) hands to its collectives, counted from the tensors it passes,
per GiB of input.

    python3 scripts/torch_collective_bytes.py [--device cpu|cuda]

Runs every distributed function, and the HTPX archive built over a group,
in a one-rank process group (gloo for "cpu", the default; NCCL for
"cuda") on silesia-like input of 2 and 4 MiB in 512-symbol blocks, with
``torch.distributed.all_reduce`` and ``all_gather`` wrapped to add up the
bytes of the tensors each call is given: an all-reduce's tensor, an
all-gather's gathered result (every rank's part: the same total at any
world size, but for the shard-size check, 8 bytes a rank). A line
through the two sizes splits each function's bytes into a part per call
and a part per input byte, and gives the bytes at 1 GiB. Then the bytes one rank sends on a ring of N = 2 and 4 ranks:
2(N-1)/N of an all-reduce's tensor, (N-1)/N of an all-gather's result.
These are counts from the shapes, not measured times or rates.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from huffman_tpu_torch.codebook import Codebook  # noqa: E402
from huffman_tpu_torch.container import sharded  # noqa: E402
from huffman_tpu_torch.corpus import silesia_like  # noqa: E402
from huffman_tpu_torch.ops.tables import tables_from_codebook  # noqa: E402
from huffman_tpu_torch.parallel import pipeline as pp  # noqa: E402

B = 512
GIB = 1 << 30
SIZES = (2 << 20, 4 << 20)


class Tally:
    """Bytes given to each collective kind while installed."""

    def __init__(self):
        self.bytes = defaultdict(int)
        self._reduce, self._gather = dist.all_reduce, dist.all_gather

    def __enter__(self):
        def all_reduce(t, *a, **kw):
            self.bytes["all_reduce"] += t.numel() * t.element_size()
            return self._reduce(t, *a, **kw)

        def all_gather(parts, t, *a, **kw):
            self.bytes["all_gather"] += sum(p.numel() * p.element_size() for p in parts)
            return self._gather(parts, t, *a, **kw)

        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        return self

    def __exit__(self, *exc):
        dist.all_reduce, dist.all_gather = self._reduce, self._gather


def count(n_bytes: int, dev: torch.device) -> dict[str, dict[str, int]]:
    """Collective bytes of each function on ``n_bytes`` of input."""
    data = silesia_like(n_bytes, seed=7)
    sym = torch.from_numpy(data.view(np.int16).copy()).to(dev).reshape(-1, B)
    n_pairs = sym.numel()
    freqs = np.bincount(data.view("<u2"), minlength=65536)
    t = tables_from_codebook(Codebook.from_frequencies(freqs), dev)
    calls = {
        "distributed_histogram": lambda: pp.distributed_histogram(sym.reshape(-1)),
        "distributed_encode": lambda: pp.distributed_encode(sym, n_pairs, t, B),
        "distributed_decode": lambda: pp.distributed_decode(
            pp.distributed_encode(sym, n_pairs, t, B)[0], t, B),
        "compress_decompress_step": lambda: pp.compress_decompress_step(sym, n_pairs, t, B),
        "distributed_encode_streams": lambda: pp.distributed_encode_streams(sym, n_pairs),
        "sharded.compress(group=)": lambda: sharded.compress(
            data.tobytes(), n_shards=4, group=dist.group.WORLD, device=dev),
    }
    out = {}
    for name, fn in calls.items():
        with Tally() as tally:
            fn()
        out[name] = dict(tally.bytes)
    # distributed_decode alone: its bytes less the encode that fed it.
    enc = out["distributed_encode"]
    out["distributed_decode"] = {
        k: v - enc.get(k, 0) for k, v in out["distributed_decode"].items() if v != enc.get(k, 0)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                                init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            small, large = (count(n, dev) for n in SIZES)
        finally:
            dist.destroy_process_group()
    print(f"collective bytes per call, B = {B}, counted at {SIZES[0] >> 20} and "
          f"{SIZES[1] >> 20} MiB and extrapolated to 1 GiB ({args.device})")
    for name in small:
        for kind in sorted(set(small[name]) | set(large[name])):
            a, b = small[name].get(kind, 0), large[name].get(kind, 0)
            per_byte = (b - a) / (SIZES[1] - SIZES[0])
            fixed = a - per_byte * SIZES[0]
            at_gib = fixed + per_byte * GIB
            ring = ", ".join(
                f"N={n}: {at_gib * (2 if kind == 'all_reduce' else 1) * (n - 1) / n:,.0f} B sent a rank"
                for n in (2, 4))
            print(f"  {name} {kind}: {a:,} B at {SIZES[0] >> 20} MiB, {b:,} B at {SIZES[1] >> 20} MiB; "
                  f"{fixed:,.0f} B a call + {per_byte * GIB:,.0f} B per GiB = {at_gib:,.0f} B at 1 GiB "
                  f"({ring})")
        if not (small[name] or large[name]):
            print(f"  {name}: no collective")
    return 0


if __name__ == "__main__":
    sys.exit(main())
