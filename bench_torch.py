#!/usr/bin/env python3
"""Throughput bench of the PyTorch port on one CUDA card: the counterpart
of bench.py (which stays the JAX package's bench).

    python3 bench_torch.py

Three rungs of 32 MiB each, made from a seed by the port's corpora:
  - ``silesia_like_32MB``: ``silesia_like(32 MiB, seed=7)``, the headline
    (~4k distinct byte pairs: tier 4096 encode);
  - ``wide30k_32MB``: ``zipf_pairs(32 MiB, 30000, rng(3))``, bench.py's
    wide30k (tier 32768);
  - ``zipf65536_32MB``: ``zipf_pairs(32 MiB, 65536, rng(11))``, the full
    alphabet, in place of bench.py's pexels rung.

Four lines a rung, each a rate in GB/s of the rung's input bytes:
  1. ``huffman_decode_throughput_<rung>``: the device-resident decode of the
     v2 container's streams to packed symbol pairs, K1 translating
     in-kernel, as ``decompress`` runs it;
  2. ``huffman_encode_throughput_<rung>``: the fused encode
     (``ops/fused.py`` ``encode_device``: K6, K7, K8 or K9, K4 and K10's
     stream deposit) on device-resident symbols, with the host reads it
     makes (the alphabet size, the largest group);
  3. ``huffman_compress_throughput_<rung>`` and
  4. ``huffman_decompress_throughput_<rung>``: ``compress(data)`` and
     ``decompress(blob)`` end to end, the host work included.

Each line checks bit-exactness before it times anything: the decoded pairs
equal the input, the fused encode's streams equal those of the container
the port's host path (the plain versions on the CPU) writes, and the
card's container equals that container and decompresses to the input.

Method: lines 1-2 time K >= 20 calls enqueued back to back between two
CUDA events (``utils.timing.amortized_times``), 5 repetitions; lines 3-4
time each call on the host clock with ``torch.cuda.synchronize()`` around
it (``utils.timing.wall_times``), 1 warm-up and 7 repetitions. L2 is not
flushed between calls: at 32 MiB a call moves
more than the card's 50 MB L2 (64 MB of int32 symbols in on encode; about
20 MB of streams in and 32 MB out on decode).

Prints one JSON line per metric (``metric``, ``value`` (the median),
``unit`` "GB/s", ``spread`` [slowest, fastest] over the repetitions,
``reps``, ``device``: the card's ``nvidia-smi`` name and power limit);
the last line is a summary. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import huffman_tpu_torch as htt
from huffman_tpu_torch.constants import DEFAULT_BLOCK_SYMBOLS, DEFAULT_MAX_CODE_LEN
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.device import resolve_device
from huffman_tpu_torch.ops.cuda_decode import decode_groups
from huffman_tpu_torch.ops.fused import encode_device
from huffman_tpu_torch.ops.histogram import bytes_to_symbols_device
from huffman_tpu_torch.utils.benchmark import BenchResult, device_line, silesia_like, zipf_pairs
from huffman_tpu_torch.utils.timing import amortized_times, wall_times

BYTES = 32 << 20
RUNGS = {
    "silesia_like_32MB": lambda n: silesia_like(n, seed=7),
    "wide30k_32MB": lambda n: zipf_pairs(n, 30000, np.random.default_rng(3)),
    "zipf65536_32MB": lambda n: zipf_pairs(n, 65536, np.random.default_rng(11)),
}
DEVICE_ITERS = 20
DEVICE_REPS = 5
E2E_REPS = 7


def decode_line(data: bytes, host_blob: bytes, tag: str, device, card: str,
                iters: int = DEVICE_ITERS, reps: int = DEVICE_REPS) -> BenchResult:
    """The device-resident v2 decode of ``host_blob``'s streams."""
    c = bf.ParsedContainer(host_blob)
    streams, n_real, tables, B = bf.v2_device_inputs(c, device)

    def run(s):
        return decode_groups(s, n_real, tables, B, True)

    out, _ = bf._decode_k1(c, streams, n_real, tables, False)
    if out[: len(data)].cpu().numpy().tobytes() != data:
        raise AssertionError(f"{tag}: decoded pairs differ from the input; benchmark invalid")
    times = amortized_times(run, streams, iters=iters, reps=reps)
    return BenchResult.from_times(f"huffman_decode_throughput_{tag}", len(data), times, card)


def encode_line(data: bytes, host_blob: bytes, tag: str, device, card: str,
                iters: int = DEVICE_ITERS, reps: int = DEVICE_REPS) -> BenchResult:
    """The fused encode on device-resident symbols."""
    B = DEFAULT_BLOCK_SYMBOLS
    n_pairs = len(data) // 2
    nblocks = -(-n_pairs // B)
    sym = bytes_to_symbols_device(bf._upload_bytes(data, n_pairs, nblocks, B, device)).reshape(-1, B)

    def run(s):
        return encode_device(s, n_pairs, DEFAULT_MAX_CODE_LEN)

    r = run(sym)
    got = bf._streams_to_host(r["streams"], r["counts"])
    want = bf.ParsedContainer(host_blob).streams
    if len(got) != len(want) or not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{tag}: fused encode streams differ from the host container's; "
                             "benchmark invalid")
    times = amortized_times(run, sym, iters=iters, reps=reps)
    return BenchResult.from_times(f"huffman_encode_throughput_{tag}", len(data), times, card)


def end_to_end_lines(data: bytes, host_blob: bytes, tag: str, device, card: str,
                     reps: int = E2E_REPS) -> list[BenchResult]:
    """``compress(data)`` and ``decompress(blob)`` on ``device``."""
    blob = htt.compress(data, device)
    if blob != host_blob:
        raise AssertionError(f"{tag}: the container differs from the host path's; benchmark invalid")
    if htt.decompress(blob, device) != data:
        raise AssertionError(f"{tag}: decompress(compress(x)) != x; benchmark invalid")
    return [
        BenchResult.from_times(f"huffman_compress_throughput_{tag}", len(data),
                               wall_times(htt.compress, data, device, iters=reps), card),
        BenchResult.from_times(f"huffman_decompress_throughput_{tag}", len(data),
                               wall_times(htt.decompress, blob, device, iters=reps), card),
    ]


def bench_rung(data: bytes, tag: str, device="cuda", reps: int | None = None,
               iters: int = DEVICE_ITERS) -> list[BenchResult]:
    """The rung's four lines, each checked before it is timed. ``reps``
    replaces both repetition counts (5 device, 7 end to end)."""
    dev = resolve_device(device)
    card = device_line(dev)
    host_blob = htt.compress(data, "cpu")  # the reference side: the plain versions
    if bf.ParsedContainer(host_blob).stored:
        raise ValueError(f"{tag}: the input does not compress (stored container); nothing to time")
    return [
        decode_line(data, host_blob, tag, dev, card, iters, reps or DEVICE_REPS),
        encode_line(data, host_blob, tag, dev, card, iters, reps or DEVICE_REPS),
        *end_to_end_lines(data, host_blob, tag, dev, card, reps or E2E_REPS),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card (torch.cuda.is_available() is False); "
              "the bench runs on the card only", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    results = []
    for tag, make in RUNGS.items():
        for r in bench_rung(make(BYTES).tobytes(), tag):
            print(r.json_line(), flush=True)
            results.append(r)
    print(json.dumps({"summary": {r.name: r.gbps for r in results},
                      "device": results[0].device, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
