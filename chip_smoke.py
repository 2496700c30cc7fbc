#!/usr/bin/env python3
"""Smoke test of the PyTorch port (huffman_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or a few:
  0. card: ``nvidia-smi --query-gpu=name,power.limit`` as the card reports it;
  1. build: the kernels from huffman_tpu_torch/csrc/ with nvcc (the
     package's own first-use build, one nvcc per source in parallel), with
     the build seconds, ptxas's spill check and K1's shared memory at the
     largest translate table (the ring, the table and its static arrays
     must fit a block's 227 KiB);
  2. each kernel against its plain PyTorch version on the same CUDA
     tensors, bit for bit, at the shapes of the main paths. The tensors are
     captured from the calls a user makes at 32 MiB:
       - the fused compress route: silesia-like (tier 4096: histogram,
         package-merge, rank-select gather, lane pack), wide30k (tier
         32768: canonical-rank gather with the rank stage) and a
         full-alphabet Zipf input (tier 65536: canonical rank by identity);
       - the package-merge of the fused encode of the 29-bit Fibonacci
         input at a 32-bit limit (tier 4096, 31 rounds);
       - the host-codebook compress route, silesia-like with a given
         codebook (the dense code gather);
       - decompress of silesia-like, of the full alphabet and of an 8 MiB
         300-symbol input (translate-mode decode, the table in shared
         memory); the silesia-like decode in rank mode with its rank ->
         symbol pairs (K2), as alphabets past the translate boundary and
         the distributed decoder run it, and again with its streams
         repeated five times along the groups (160 groups: more blocks
         than the card's 132 SMs); the full-alphabet streams repeated eight
         times along the groups (256 groups, the resident cell's shape),
         in translate mode;
       - the histogram again on a view of the silesia-like symbols 2 bytes
         past a 16-byte boundary, with n_valid % 8 == 3 (its unaligned
         head and its tail), and the canonical-rank gather on the same
         kind of view of the wide30k symbols (its funnel-shifted loads
         and its tail);
       - the lane pack at the full-alphabet shape as well as silesia-like;
       - the in-kernel deposit (K10) on the arguments the silesia-like and
         full-alphabet compresses hand it;
       - the unpacked rank-mode decode's rank -> symbol lookup (K5) on the
         wide30k and full-alphabet decodes;
       - the CRC32 of the decoded words (K11) on the words the silesia-like
         decompress hands it, on a view of them 4 bytes past a 16-byte
         boundary with a ragged tail (its unaligned head and its tail), and
         on the 256 MiB of words K1 writes at 256 groups (8,192 tiles
         into its one-block combine).
     Times from CUDA events, with each kernel's bound (the larger of its
     bytes over 3.35 TB/s and its integer operations over 16.7 Tops/s) and,
     where one PyTorch call computes the same function, that call's time.
     A kernel timed at several shapes is recorded by its slowest, with every
     shape under ``variants``. Package-merge's chain of dependent
     launches is the count of device kernels ``torch.profiler`` records
     in one call of each shape, read after phase 3 (``profiler_kernels``;
     the smoke fails if it records none);
  3. the paths, each with the launch counts set to 0 just before it and
     read just after: the fused route (compress + decompress of the three
     32 MiB inputs and the 8 MiB one), the host-codebook route (32 MiB
     silesia-like with a given codebook, and small edge inputs), the v1
     route (32 MiB silesia-like in per-block slabs), the wide-code route
     (the 29-bit Fibonacci input in v2 and v1, and the fused encode at a
     32-bit limit), the reference route (the ``.compressed`` format at 32
     MiB, and its host decode of a 1 MiB prefix) and the ops route (the
     in-kernel deposit path against ``pack_streams``, rank mode asked
     for explicitly: K1 + K2 against K1 translate and the unpacked decode
     (K5) against the packed one, the on-device roundtrip at 32 MiB), the
     resident route (the full-alphabet container held on the card as a
     ``ResidentContainer``, decoded into a CUDA tensor three times, equal
     to the input, K1 and K11 launched once a call and nothing else), the
     front-end route (an HTPS stream of 64 MiB silesia-like in 16 MiB
     chunks with ``pipeline`` 2 and 1, which must write the same bytes,
     with their wall times; HTPX archives of the 32 MiB silesia-like in 4
     shards in both codebook modes; the command line in-process for
     compress, ``--stream-mb 16``, info, decompress, verify, archive and
     transcode, each file equal to the API's output, and one ``python -m
     huffman_tpu_torch verify``) and the distributed route (an NCCL
     process group of world size 1 on the card, destroyed at its end:
     ``distributed_encode_streams`` of silesia-like and of the full
     alphabet, ``distributed_decode_groups`` in rank mode at the full
     alphabet, packed and unpacked, ``distributed_encode`` /
     ``distributed_decode`` and ``compress_decompress_step``, each equal
     to the single-device functions on the same tensors), the native
     route (the port's C++ host runtime, built with g++, must load: the
     reference decode of the 32 MiB silesia-like container, the 1 MiB
     prefix's against the Python loop, bytes and a truncated blob's
     exception, with both rates; the host histogram against ``np.bincount``;
     HTPX global mode again, on the native histogram) and the bench route
     (``bench_torch.py``'s silesia-like rung, each line checked before it is
     timed, 3 repetitions). Every container must equal the one the port's
     CPU path (the plain versions, held equal to the JAX package by the CPU
     tests) writes, and every decompress must return the input. Each path's
     kernels must all have launched in its run: K4 and K10 on every v2
     compress route, K1 and K11 on every decompress; K2 and K5 on the ops
     and distributed routes, where rank mode is asked for.

The line before the card's JSON lines gives the smoke's wall seconds; the
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Without a CUDA card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"
BIG = 32 << 20
TRANSLATE_BYTES = 8 << 20
HBM_BYTES_PER_MS = 3.35e12 / 1e3   # H100 SXM device memory, bytes per ms
# H100 SXM 32-bit integer rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost.
OPS_PER_MS = 132 * 64 * 1.98e9 / 1e3

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "decode_groups": ("huffman_tpu_torch/csrc/decode.cu", "huffman_tpu/ops/pallas_decode.py:242"),
    "gather_u16_pairs": ("huffman_tpu_torch/csrc/gather.cu", "huffman_tpu/ops/pallas_gather.py:592"),
    "gather_codes": ("huffman_tpu_torch/csrc/gather.cu", "huffman_tpu/ops/pallas_gather.py:138"),
    "gather_u16": ("huffman_tpu_torch/csrc/gather.cu", "huffman_tpu/ops/pallas_gather.py:538"),
    "pack_lanes": ("huffman_tpu_torch/csrc/pack.cu", "huffman_tpu/ops/pallas_encode.py:39"),
    "deposit_streams": ("huffman_tpu_torch/csrc/deposit.cu", "huffman_tpu/ops/pallas_encode.py:409"),
    "histogram": ("huffman_tpu_torch/csrc/hist.cu", "huffman_tpu/ops/pallas_hist.py:48"),
    "package_merge": ("huffman_tpu_torch/csrc/package_merge.cu", "huffman_tpu/ops/device_codebook.py:62"),
    "gather_rank_select": ("huffman_tpu_torch/csrc/rank_gather.cu", "huffman_tpu/ops/pallas_gather.py:270"),
    "gather_rank_canonical": ("huffman_tpu_torch/csrc/rank_gather.cu", "huffman_tpu/ops/pallas_gather.py:363"),
    "crc32_words": ("huffman_tpu_torch/csrc/crc32.cu",
                    "none: the JAX package checks the CRC32 with zlib on the host "
                    "(huffman_tpu/container/block_format.py:742)"),
}
FUSED_PATH = ("histogram", "package_merge", "gather_rank_select", "gather_rank_canonical",
              "pack_lanes", "deposit_streams", "decode_groups", "crc32_words")
HOST_PATH = ("gather_codes", "pack_lanes", "deposit_streams", "decode_groups", "crc32_words")
V1_PATH = ("gather_codes", "pack_lanes", "crc32_words")
WIDE_PATH = ("pack_lanes", "deposit_streams", "histogram", "package_merge", "decode_groups",
             "crc32_words")
REFERENCE_PATH = ("gather_codes",)
OPS_PATH = ("deposit_streams", "gather_u16", "pack_lanes", "decode_groups", "gather_u16_pairs",
            "histogram", "package_merge", "gather_rank_select", "crc32_words")
FRONT_END_PATH = ("histogram", "package_merge", "gather_rank_select", "pack_lanes", "deposit_streams",
                  "decode_groups", "gather_codes", "crc32_words")
DISTRIBUTED_PATH = ("histogram", "package_merge", "gather_rank_select", "gather_rank_canonical",
                    "pack_lanes", "deposit_streams", "decode_groups", "gather_u16_pairs", "gather_u16",
                    "gather_codes")
RESIDENT_PATH = ("decode_groups", "crc32_words")
NATIVE_PATH = ("gather_codes", "pack_lanes", "deposit_streams", "decode_groups", "crc32_words")
BENCH_PATH = ("histogram", "package_merge", "gather_rank_select", "pack_lanes", "deposit_streams",
              "decode_groups", "crc32_words")
HTPS_BYTES = 64 << 20


def check_no_spills(log: str, kernels: tuple[str, ...]) -> None:
    """Fail if ptxas reports spill stores or loads for a function whose
    name holds one of ``kernels``. An empty log (a library built before)
    is reported and not checked."""
    if not log:
        print("ptxas: library built before this run; spills not read")
        return
    current, seen = None, set()
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line and current:
            hit = [k for k in kernels if k in current]
            stores, loads = (int(n) for n in re.findall(r"(\d+) bytes spill", line))
            if hit and (stores or loads):
                raise AssertionError(f"ptxas: {current} spills ({line.strip()})")
            seen.update(hit)
    if missing := set(kernels) - seen:
        raise AssertionError(f"ptxas: no properties line for {sorted(missing)}")
    print(f"ptxas: no spills in {', '.join(kernels)}")


def check_k1_shared_memory(log: str) -> None:
    """K1 in translate mode holds its stream ring and a table of up to
    ``TRANSLATE_MAX_ALPHABET`` u16 symbols in dynamic shared memory beside
    its static arrays: fail unless the largest sum fits a block's 227 KiB.
    An empty log (a library built before) is reported and not checked."""
    from huffman_tpu_torch.ops.cuda_decode import TRANSLATE_MAX_ALPHABET

    if not log:
        print("ptxas: library built before this run; K1's shared memory not read")
        return
    current, static = None, None
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line.rsplit(" ", 1)[-1]
        elif current and "decode_groups_kernelILb1E" in current and "bytes smem" in line:
            static = int(re.search(r"(\d+) bytes smem", line).group(1))
            break
    if static is None:
        raise AssertionError("ptxas: no shared-memory line for K1's translate kernel")
    ring, table = 16384 * 4, (2 * TRANSLATE_MAX_ALPHABET + 15) // 16 * 16
    total = static + ring + table
    print(f"ptxas: K1 translate shared memory: static {static} + ring {ring} + table of "
          f"{TRANSLATE_MAX_ALPHABET} symbols {table} = {total} of 232448 bytes a block")
    if total > 232448:
        raise AssertionError(f"K1's shared memory at {TRANSLATE_MAX_ALPHABET} symbols exceeds a block's")


def device_kernels(fn) -> int:
    """Device kernels ``torch.profiler`` records in one call of ``fn``."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: the CPU ops that launched them are counted apart.
    return sum(e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))


def fibonacci_raw(fib: bytes, B: int = 512) -> tuple[torch.Tensor, int]:
    """The Fibonacci input as the fused encode takes it: zero-padded to
    whole groups of 1024 lanes of B pairs, and its pair count."""
    n_pairs = len(fib) // 2
    n_lanes = -(-n_pairs // (B * 1024)) * 1024
    raw = torch.zeros(n_lanes * B * 2, dtype=torch.uint8)
    raw[: len(fib)] = torch.frombuffer(bytearray(fib), dtype=torch.uint8)
    return raw, n_pairs


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up."""
    from huffman_tpu_torch.utils.timing import amortized_time_fn

    return amortized_time_fn(lambda _: fn(), None, iters=iters, reps=1) * 1e3


def capture(calls: list[tuple[object, str]], fn, *args, **kwargs):
    """Run ``fn``; return its result and the arguments of the first call
    of each wrapper ``module.name`` in ``calls`` during it."""
    seen, originals = {}, {}
    for mod, name in calls:
        originals[(mod, name)] = orig = getattr(mod, name)

        def recorder(*a, _orig=orig, _name=name):
            seen.setdefault(_name, a)
            return _orig(*a)

        setattr(mod, name, recorder)
    try:
        result = fn(*args, **kwargs)
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)
    return result, seen


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def work(name: str, args, out) -> tuple[int, int]:
    """(bytes, operations) the function must move and do for these inputs:
    each input read once, each output written once; operations are the
    per-element integer work of the algorithm."""
    outs = out if isinstance(out, tuple) else (out,)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if name == "histogram":
        sym, n_valid = args
        return 2 * n_valid + nbytes(*outs), 3 * n_valid
    if name == "package_merge":
        freqs, n, max_len, K = args
        n_sym = freqs.numel()
        # a comparison sort of the leaves, then a 2K-item merge per round
        ops = n_sym * int(np.log2(n_sym)) + (max_len - 1) * 2 * K * int(np.log2(2 * K))
        return nbytes(freqs, *outs), ops
    if name in ("gather_rank_select", "gather_rank_canonical", "gather_codes"):
        sym = args[0]
        per = {"gather_rank_select": 8, "gather_rank_canonical": 40, "gather_codes": 3}[name]
        return nbytes(*tensors, *outs), per * sym.numel()
    if name == "pack_lanes":
        return nbytes(*tensors, *outs), 12 * args[0].numel()
    if name == "gather_u16_pairs":
        return nbytes(*tensors, *outs), 6 * args[0].numel()
    if name == "gather_u16":
        return nbytes(*tensors, *outs), 3 * args[0].numel()
    if name == "deposit_streams":
        # per lane and step: the fire bit, the counting ballot, and in the
        # walk the ballot, the step base, the rank, the slot and the carries
        return nbytes(*tensors, *outs), 15 * args[0].shape[0] * (args[0].shape[1] - 1)
    if name == "decode_groups":
        streams, n_real, tables, n_steps, translate = args
        ops = 40 * streams.shape[0] * 1024 * n_steps
        return nbytes(streams, n_real, tables.lj_limit, tables.base, tables.sym_order, *outs), ops
    if name == "crc32_words":
        # each byte read once; a byte's index, table lookup and XOR
        words, n_bytes = args
        return n_bytes + nbytes(*outs), 3 * n_bytes
    raise KeyError(name)


def bound(name: str, args, out) -> tuple[float, str]:
    b, ops = work(name, args, out)
    t_bytes, t_ops = b / HBM_BYTES_PER_MS, ops / OPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name: str, args):
    """One PyTorch call computing the same function on the same inputs, or
    None. Its inputs are prepared here, outside the timed call."""
    if name == "histogram":
        sym, n_valid = args
        idx = sym.reshape(-1)[:n_valid].to(torch.int64) & 0xFFFF
        return lambda: torch.bincount(idx, minlength=65536)
    if name == "gather_codes":
        sym, table, _ = args
        idx = sym.to(torch.int64) & 0xFFFF
        return lambda: table[idx]
    if name == "gather_u16_pairs":
        packed, table = args
        u = packed.to(torch.int64) & 0xFFFFFFFF
        idx = torch.stack([u & 0xFFFF, u >> 16]).clamp(max=table.numel() - 1)
        return lambda: table[idx]
    if name == "gather_u16":
        ranks, table = args
        idx = ranks.to(torch.int64).clamp(0, table.numel() - 1)
        return lambda: table[idx]
    return None


def slowest(variants: list[dict]) -> dict:
    """A kernel's record: its slowest shape's numbers, the largest error
    over all shapes, and every shape under ``variants``."""
    top = max(variants, key=lambda v: v["ms"])
    rec = {k: v for k, v in top.items() if k != "variant"}
    rec["max_abs_err"] = max(v["max_abs_err"] for v in variants)
    return {**rec, "variants": variants}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import huffman_tpu_torch as ht
    from huffman_tpu_torch.codebook import package_merge_lengths
    from huffman_tpu_torch.container import block_format as bf
    from huffman_tpu_torch.corpus import fibonacci_pairs, silesia_like, wide30k, zipf_pairs
    from huffman_tpu_torch.ops import (
        cuda_crc,
        cuda_decode,
        cuda_encode,
        cuda_gather,
        cuda_hist,
        device_codebook,
        fused,
    )
    from huffman_tpu_torch.runtime import kernels
    from huffman_tpu_torch.utils.benchmark import device_line

    dev = torch.device(DEVICE)
    card = device_line(dev)
    print(card)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib, log = kernels.build()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    check_no_spills(log, ("decode_groups_kernel", "pack_lanes_kernel", "leaf_tile_sort",
                          "leaf_merge_pass", "leaves_init", "pm_round", "pm_count", "pm_one_block",
                          "deposit_streams_kernel", "histogram_kernel", "rank_canonical_kernel",
                          "crc32_tiles_kernel", "crc32_combine_kernel"))
    check_k1_shared_memory(log)

    silesia = silesia_like(BIG, seed=7).tobytes()
    wide = wide30k(BIG).tobytes()
    full = zipf_pairs(BIG, 65536, np.random.default_rng(11)).tobytes()
    small = zipf_pairs(TRANSLATE_BYTES, 300, np.random.default_rng(5)).tobytes()
    fib = fibonacci_pairs().tobytes()
    n_full = int(np.unique(np.frombuffer(full, "<u2")).size)
    print(f"full-alphabet input: {n_full} distinct symbols")
    if n_full <= 32768:
        raise AssertionError("the full-alphabet input must exceed the 32768 tier")

    # Phase 2: kernel vs plain at the main paths' shapes.
    fused_calls = [(fused, "histogram"), (device_codebook, "package_merge"),
                   (fused, "gather_rank_select"), (fused, "gather_rank_canonical"),
                   (cuda_encode, "pack_lanes"), (cuda_encode, "_deposit_inputs"), (cuda_encode, "_deposit")]
    blob, enc = capture(fused_calls, ht.compress, silesia, dev)
    blob_wide, enc_wide = capture(fused_calls, ht.compress, wide, dev)
    blob_full, enc_full = capture(fused_calls, ht.compress, full, dev)
    blob_small = ht.compress(small, dev)
    codebook = bf.ParsedContainer(blob).codebook
    _, enc_host = capture([(cuda_gather, "gather_codes")], ht.compress, silesia, dev, codebook=codebook)
    _, dec = capture([(bf, "decode_groups"), (bf, "crc32_words")], ht.decompress, blob, dev)
    _, dec_tr = capture([(bf, "decode_groups")], ht.decompress, blob_small, dev)
    _, dec_wide = capture([(bf, "decode_groups")], ht.decompress, blob_wide, dev)
    _, dec_full = capture([(bf, "decode_groups")], ht.decompress, blob_full, dev)
    assert all(d["decode_groups"][4] for d in (dec, dec_tr, dec_wide, dec_full)), "decompress translates in K1"
    assert not enc_wide["gather_rank_canonical"][-1] and enc_full["gather_rank_canonical"][-1], \
        "canonical gather modes"
    raw_fib, fib_pairs = fibonacci_raw(fib)
    _, enc_fib = capture([(device_codebook, "package_merge")], fused.encode_device_bytes,
                         raw_fib.to(dev), fib_pairs, 512, 32)
    K = [a["package_merge"][3] for a in (enc, enc_wide, enc_full, enc_fib)]
    assert K == [4096, 32768, 65536, 4096] and enc_fib["package_merge"][2] == 32, f"tiers {K}"
    # K10's inputs as the compress routes hand them to it, and the stream
    # assembly's arguments (codes, protocol lengths, real lanes, cap) for
    # the tensor-op pack_streams. Rank mode (K1 then K2, and K5 unpacked)
    # is the decode of alphabets past TRANSLATE_MAX_ALPHABET and of the
    # distributed decoder: its inputs are the decompress calls' in rank mode.
    deposit = {"silesia": enc["_deposit"], "full": enc_full["_deposit"]}
    pack_args = {name: (*e["_deposit_inputs"], e["_deposit"][3])
                 for name, e in (("silesia", enc), ("full", enc_full))}
    dec_rank = (*dec["decode_groups"][:4], False)
    pairs_args = (cuda_decode.decode_groups(*dec_rank), dec_rank[2].sym_order)
    unpacked = {name: capture([(cuda_decode, "gather_u16")], cuda_decode.decode_groups,
                              *d["decode_groups"][:4], False, False)[1]["gather_u16"]
                for name, d in (("wide30k", dec_wide), ("full", dec_full))}

    # The groups are independent, so the silesia-like streams repeated
    # along the groups are a valid 160-group input.
    streams, n_real, *rest = dec_rank
    dec_160 = (streams.repeat(5, 1), n_real.repeat(5), *rest)
    cg, ce, cd, ch, dc = cuda_gather, cuda_encode, cuda_decode, cuda_hist, device_codebook
    # The full-alphabet streams repeated 8 times along the groups: the
    # resident cell's shape, 256 groups of K1 with the 65,536-symbol table
    # in translate mode, and K11 over the 256 MiB of words it writes.
    streams, n_real, *rest = dec_full["decode_groups"]
    dec_256 = (streams.repeat(8, 1), n_real.repeat(8), *rest)
    words_256 = cd.decode_groups(*dec_256).reshape(-1)
    crc_256 = (words_256, 4 * words_256.numel())
    del streams, n_real, rest
    # K6 on a view 2 bytes past a 16-byte boundary, n_valid % 8 == 3: the
    # kernel's unaligned head and its tail.
    sym, n_valid = enc["histogram"]
    hist_odd = (sym.reshape(-1)[1:], n_valid - 5)
    # K9 on the same kind of view of the wide30k rank-stage arguments.
    sym9, n_valid9, *tables9 = enc_wide["gather_rank_canonical"]
    canon_odd = (sym9.reshape(-1)[1:], n_valid9 - 5, *tables9)
    # K11 on the decompress's words, and 4 bytes past a 16-byte boundary
    # with a ragged tail: its unaligned head and its tail.
    crc_words, crc_bytes = dec["crc32_words"]
    crc_odd = (crc_words.reshape(-1)[1:], crc_bytes - 4 - 6)

    checks = [  # (record name, variant, kernel, plain, args, iters, plain iters)
        ("histogram", "silesia", ch.histogram, ch.histogram_plain, enc["histogram"], 20, 3),
        ("histogram", "full", ch.histogram, ch.histogram_plain, enc_full["histogram"], 20, 3),
        ("histogram", "silesia, odd offset and length", ch.histogram, ch.histogram_plain, hist_odd, 20, 3),
        ("package_merge", "K=4096", dc.package_merge, dc.package_merge_plain, enc["package_merge"], 10, 2),
        ("package_merge", "K=32768", dc.package_merge, dc.package_merge_plain, enc_wide["package_merge"], 10, 2),
        ("package_merge", "K=65536", dc.package_merge, dc.package_merge_plain, enc_full["package_merge"], 10, 2),
        ("package_merge", "K=4096, max_len 32, fibonacci", dc.package_merge, dc.package_merge_plain,
         enc_fib["package_merge"], 10, 2),
        ("gather_rank_select", "silesia", cg.gather_rank_select, cg.gather_rank_select_plain,
         enc["gather_rank_select"], 20, 2),
        ("gather_rank_canonical", "rank stage, wide30k", cg.gather_rank_canonical,
         cg.gather_rank_canonical_plain, enc_wide["gather_rank_canonical"], 20, 2),
        ("gather_rank_canonical", "identity, full", cg.gather_rank_canonical,
         cg.gather_rank_canonical_plain, enc_full["gather_rank_canonical"], 20, 2),
        ("gather_rank_canonical", "rank stage, wide30k, odd offset and length", cg.gather_rank_canonical,
         cg.gather_rank_canonical_plain, canon_odd, 20, 2),
        ("pack_lanes", "silesia", ce.pack_lanes, ce.pack_lanes_plain, enc["pack_lanes"], 10, 2),
        ("pack_lanes", "full", ce.pack_lanes, ce.pack_lanes_plain, enc_full["pack_lanes"], 10, 2),
        ("gather_codes", "silesia", cg.gather_codes, cg.gather_codes_plain, enc_host["gather_codes"], 20, 3),
        ("decode_groups", "rank mode, silesia", cd.decode_groups, cd.decode_groups_plain, dec_rank, 5, 2),
        ("gather_u16_pairs", "silesia", cg.gather_u16_pairs, cg.gather_u16_pairs_plain, pairs_args, 20, 3),
        ("decode_groups", "translate mode, silesia", cd.decode_groups, cd.decode_groups_plain,
         dec["decode_groups"], 5, 2),
        ("decode_groups", "translate mode, 300 symbols", cd.decode_groups, cd.decode_groups_plain,
         dec_tr["decode_groups"], 5, 2),
        ("decode_groups", "translate mode, full alphabet", cd.decode_groups, cd.decode_groups_plain,
         dec_full["decode_groups"], 5, 2),
        ("decode_groups", "rank mode, 160 groups", cd.decode_groups, cd.decode_groups_plain,
         dec_160, 5, 1),
        ("decode_groups", "translate mode, full alphabet, 256 groups", cd.decode_groups,
         cd.decode_groups_plain, dec_256, 5, 1),
        ("deposit_streams", "silesia", ce._deposit, ce.deposit_streams_plain, deposit["silesia"], 10, 1),
        ("deposit_streams", "full", ce._deposit, ce.deposit_streams_plain, deposit["full"], 10, 1),
        ("gather_u16", "wide30k", cg.gather_u16, cg.gather_u16_plain, unpacked["wide30k"], 20, 3),
        ("gather_u16", "full", cg.gather_u16, cg.gather_u16_plain, unpacked["full"], 20, 3),
        ("crc32_words", "silesia", cuda_crc.crc32_words, cuda_crc.crc32_words_plain, dec["crc32_words"],
         20, 2),
        ("crc32_words", "silesia, odd offset and length", cuda_crc.crc32_words, cuda_crc.crc32_words_plain,
         crc_odd, 20, 2),
        ("crc32_words", "256 MiB of full-alphabet K1 words", cuda_crc.crc32_words,
         cuda_crc.crc32_words_plain, crc_256, 10, 1),
    ]
    records, k7_args = {}, {}
    for name, variant, kernel, plain, args, iters, plain_iters in checks:
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: kernel(*args), iters)
        plain_ms = cuda_ms(lambda: plain(*args), plain_iters)
        lib_fn = library_call(name, args)
        library_ms = cuda_ms(lib_fn, iters) if lib_fn else None
        bound_ms, bound_by = bound(name, args, got)
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        lib_txt = f" library {library_ms:.4f} ms" if lib_fn else ""
        rec = {"variant": variant, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        if name == "package_merge":
            # Its time is set by a chain of dependent launches (or a
            # block's barriers), which the byte and operation bound does
            # not see: the profiler counts them at the end.
            k7_args[variant] = (rec, args)
        print(f"kernel {name} [{variant}]: shapes {shapes} max_abs_err {err} kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms{lib_txt} bound {bound_ms:.4f} ms "
              f"({bound_by}) ({card})")
        if err != 0:
            raise AssertionError(f"{name} [{variant}]: kernel differs from its plain version")
        records.setdefault(name, []).append(rec)
    del enc_host, dec, dec_tr, dec_wide, dec_full, dec_rank, pairs_args, dec_160, checks, deposit, unpacked
    del crc_words, crc_odd, dec_256, words_256, crc_256
    del enc, enc_wide, enc_full, enc_fib, hist_odd, canon_odd

    # Phase 3: the paths, counting launches.
    def drive(name, data, **kwargs):
        times_c, times_d = [], []
        for _ in range(3 if len(data) >= TRANSLATE_BYTES else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = ht.compress(data, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = ht.decompress(blob)
            torch.cuda.synchronize()
            times_c.append(t1 - t0)
            times_d.append(time.perf_counter() - t1)
            if out != data:
                raise AssertionError(f"{name}: decompress(compress(x)) != x")
        c, d = statistics.median(times_c), statistics.median(times_d)
        rate = (f"compress {len(data) / c / 1e9:.3f} GB/s, decompress "
                f"{len(data) / d / 1e9:.3f} GB/s" if len(data) >= TRANSLATE_BYTES else
                f"compress {c * 1e3:.1f} ms, decompress {d * 1e3:.1f} ms")
        print(f"slice {name}: {len(data)} B -> {len(blob)} B (ratio "
              f"{len(blob) / max(len(data), 1):.4f}); median of {len(times_c)}: "
              f"{rate} ({card})")
        return blob

    def run_path(label, path_kernels, inputs, extra=None):
        """Drive ``inputs`` (and ``extra``) with the launch counts set to 0
        just before and read just after; every container must equal the
        port's CPU path's."""
        kernels.reset_launch_counts()
        blobs = {name: drive(name, data, **kw) for name, (data, kw) in inputs.items()}
        if extra:
            extra()
        counts = kernels.launch_counts()
        print(f"path {label}: launches {json.dumps({k: counts[k] for k in path_kernels})}")
        missing = [k for k in path_kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        for name, (data, kw) in inputs.items():
            if blobs[name] != ht.compress(data, "cpu", **kw):
                raise AssertionError(f"{name}: card container differs from the CPU path's")
        return counts

    path_counts = [run_path("fused route", FUSED_PATH, {
        "silesia_like_32MiB": (silesia, {}),
        "wide30k_32MiB": (wide, {}),
        "full_alphabet_32MiB": (full, {}),
        "zipf300_8MiB": (small, {}),
    })]
    path_counts.append(run_path("host-codebook route", HOST_PATH, {
        "silesia_like_32MiB_given_codebook": (silesia, {"codebook": codebook}),
        "odd_length": (small[: (1 << 20) + 1], {}),
        "one_byte": (b"\x01", {}),
        "empty": (b"", {}),
        "random_bytes": (np.random.default_rng(1).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(), {}),
    }))
    path_counts.append(run_path("v1 route", V1_PATH, {
        "silesia_like_32MiB_blocks": (silesia, {"mode": "blocks"}),
    }))

    def fused_at_32_bits():
        r = fused.encode_device_bytes(raw_fib.to(dev), fib_pairs, 512, 32)
        want = package_merge_lengths(np.bincount(np.frombuffer(fib, "<u2"), minlength=65536), 32)
        if not np.array_equal(r["lengths"].cpu().numpy(), want):
            raise AssertionError("fused encode at max_len 32: lengths differ from package-merge")
        print(f"fused encode at max_len 32: fibonacci lengths up to {int(want.max())} bits "
              f"equal the host package-merge")

    path_counts.append(run_path("wide-code route", WIDE_PATH, {
        "fibonacci_29bit_v2": (fib, {"max_code_len": None}),
        "fibonacci_29bit_v1": (fib, {"max_code_len": None, "mode": "blocks"}),
    }, extra=fused_at_32_bits))

    def reference_route():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = ht.compress_reference(silesia)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if ref != ht.compress_reference(silesia, "cpu"):
            raise AssertionError("reference container differs from the CPU path's")
        prefix = silesia[: 1 << 20]
        ref_prefix = ht.compress_reference(prefix)
        t0 = time.perf_counter()
        out = ht.decompress_reference(ref_prefix)
        t_dec = time.perf_counter() - t0
        if out != prefix:
            raise AssertionError("decompress_reference(compress_reference(x)) != x")
        c = statistics.median(times)
        print(f"slice reference_silesia_like_32MiB: {len(silesia)} B -> {len(ref)} B (ratio "
              f"{len(ref) / len(silesia):.4f}); compress median of 3: {len(silesia) / c / 1e9:.3f} GB/s; "
              f"host decompress_reference of a {len(prefix)} B prefix: {t_dec:.2f} s, "
              f"{len(prefix) / t_dec / 1e6:.3f} MB/s ({card})")

    path_counts.append(run_path("reference route", REFERENCE_PATH, {}, extra=reference_route))

    def ops_route():
        for name, args in pack_args.items():
            want_s, want_c = cuda_encode.pack_streams(*args)
            got_s, got_c = cuda_encode.pack_streams_kernel_deposit(*args)
            if not torch.equal(got_c, want_c):
                raise AssertionError(f"deposit path [{name}]: counts differ from pack_streams'")
            w = want_s.shape[1]
            slot = torch.arange(got_s.shape[1], device=dev)[None, :]
            inside = slot < want_c[:, None]
            if not (torch.equal(got_s[:, :w][inside[:, :w]], want_s[inside[:, :w]])
                    and not got_s[~inside].any()):
                raise AssertionError(f"deposit path [{name}]: streams differ from pack_streams'")
            print(f"ops deposit [{name}]: pack_streams_kernel_deposit equals pack_streams over "
                  f"{int(want_c.sum())} words in {want_c.numel()} groups, zero after")
        for name, blob_x in (("wide30k", blob_wide), ("full", blob_full)):
            # Rank mode asked for explicitly: K1's ranks, then K2 packed or
            # K5 unpacked, against the translate mode decompress runs.
            _, d = capture([(bf, "decode_groups")], ht.decompress, blob_x, dev)
            args = d["decode_groups"][:4]
            tables = args[2]
            translated = cuda_decode.decode_groups(*args, True)
            packed = cuda_gather.gather_u16_pairs(cuda_decode.decode_groups(*args, False), tables.sym_order)
            got = cuda_decode.decode_groups(*args, False, False)
            want = torch.stack([packed & 0xFFFF, (packed >> 16) & 0xFFFF], dim=2).reshape(got.shape)
            if not (torch.equal(packed, translated) and torch.equal(got, want)):
                raise AssertionError(f"rank-mode decode [{name}] differs from the translate mode")
            print(f"ops rank-mode decode [{name}]: K1 + K2 equals K1 translate; unpacked (K5) "
                  f"{tuple(got.shape)} equals the packed pairs")
        B = 512
        n_pairs = len(silesia) // 2
        sym = torch.frombuffer(bytearray(silesia), dtype=torch.int16).to(dev).reshape(-1, B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok, words = fused.roundtrip_device(sym, n_pairs, 18)
        ok = bool(ok)
        t_rt = time.perf_counter() - t0
        if not ok:
            raise AssertionError("roundtrip_device at 32 MiB failed")
        print(f"ops roundtrip_device silesia_like_32MiB: ok, {int(words)} payload words, "
              f"{t_rt:.3f} s ({card})")

    path_counts.append(run_path("ops route", OPS_PATH, {}, extra=ops_route))

    def timed(fn, *args, repeat=3, **kwargs):
        """(result, median wall seconds) of ``fn``, synchronised."""
        walls = []
        for _ in range(repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return result, statistics.median(walls)

    def resident_route():
        # The full-alphabet container held on the card, decoded into a
        # CUDA tensor: K1 and K11 once a call, and no other kernel.
        h = ht.ResidentContainer(blob_full, dev)
        want = torch.frombuffer(bytearray(full), dtype=torch.uint8).to(dev)
        kernels.reset_launch_counts()
        out, t = timed(ht.decompress, h)
        if not torch.equal(out, want):
            raise AssertionError("resident decode of the full-alphabet container != its input")
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        if launched != {"decode_groups": 3, "crc32_words": 3}:
            raise AssertionError(f"resident route: launches {launched}, not K1 and K11 once a call")
        print(f"resident full_alphabet_32MiB: {h.nbytes} B held on the card; median of 3 "
              f"{t * 1e3:.3f} ms ({len(full) / t / 1e9:.3f} GB/s), equal to the input ({card})")

    path_counts.append(run_path("resident route", RESIDENT_PATH, {}, extra=resident_route))

    def front_end_route():
        import tempfile

        from huffman_tpu_torch import cli
        from huffman_tpu_torch.container import sharded, streaming

        big = silesia_like(HTPS_BYTES, seed=7).tobytes()
        htps = {}
        for p in (2, 1):
            htps[p], c = timed(streaming.compress_bytes, big, pipeline=p)
            out, d = timed(streaming.decompress_bytes, htps[p], pipeline=p)
            if out != big:
                raise AssertionError(f"HTPS pipeline={p}: decompress_bytes(compress_bytes(x)) != x")
            print(f"htps silesia_like_64MiB pipeline={p}: {len(big)} B -> {len(htps[p])} B in "
                  f"{-(-len(big) // streaming.DEFAULT_CHUNK_BYTES)} chunks; median of 3: compress {c:.4f} s "
                  f"({len(big) / c / 1e9:.3f} GB/s), decompress {d:.4f} s ({len(big) / d / 1e9:.3f} GB/s) "
                  f"({card})")
        if htps[1] != htps[2]:
            raise AssertionError("HTPS: pipeline=1 and pipeline=2 wrote different bytes")
        if htps[2] != streaming.compress_bytes(big, device="cpu"):
            raise AssertionError("HTPS: card stream differs from the CPU path's")
        del big, htps
        for mode in ("global", "per-shard"):
            blob, c = timed(sharded.compress, silesia, n_shards=4, codebook_mode=mode)
            out, d = timed(ht.decompress, blob)
            if out != silesia:
                raise AssertionError(f"HTPX {mode}: decompress(compress(x)) != x")
            if blob != sharded.compress(silesia, n_shards=4, codebook_mode=mode, device="cpu"):
                raise AssertionError(f"HTPX {mode}: card archive differs from the CPU path's")
            print(f"htpx silesia_like_32MiB {mode}, 4 shards: {len(silesia)} B -> {len(blob)} B; "
                  f"median of 3: compress {len(silesia) / c / 1e9:.3f} GB/s, decompress "
                  f"{len(silesia) / d / 1e9:.3f} GB/s ({card})")
        # The command line in-process, each file against the API's output on
        # the card (held against the CPU path above and in the fused and
        # reference routes), then `python -m huffman_tpu_torch verify`.
        with tempfile.TemporaryDirectory() as tmp:
            src = f"{tmp}/s.bin"
            with open(src, "wb") as f:
                f.write(silesia)
            want = {
                "s.bin.htpu": ht.compress(silesia),
                "s.htps": streaming.compress_bytes(silesia),
                "s.compressed": ht.compress_reference(silesia),
                "t.compressed": ht.compress_reference(silesia),
                "s.out": silesia,
            }
            t0 = time.perf_counter()
            for argv in (["compress", src], ["compress", src, "--stream-mb", "16", "-o", f"{tmp}/s.htps"],
                         ["info", f"{tmp}/s.htps"], ["decompress", f"{tmp}/s.htps", "-o", f"{tmp}/s.out"],
                         ["verify", f"{tmp}/s.bin.htpu"], ["archive", src, "-o", f"{tmp}/s.compressed"],
                         ["info", f"{tmp}/s.compressed"],
                         ["transcode", f"{tmp}/s.bin.htpu", "--to", "reference", "-o", f"{tmp}/t.compressed"]):
                if cli.main(argv) != 0:
                    raise AssertionError(f"cli {argv[0]}: non-zero exit")
            t_cli = time.perf_counter() - t0
            for name, blob in want.items():
                with open(f"{tmp}/{name}", "rb") as f:
                    if f.read() != blob:
                        raise AssertionError(f"cli: {name} differs from the API's output")
            r = subprocess.run([sys.executable, "-m", "huffman_tpu_torch", "verify", f"{tmp}/s.htps"],
                               capture_output=True, text=True, timeout=300,
                               cwd=str(Path(__file__).resolve().parent))
            if r.returncode != 0 or not r.stdout.startswith(f"OK: {len(silesia)} bytes"):
                raise AssertionError(f"python -m huffman_tpu_torch verify: {r.returncode} {r.stderr[-2000:]}")
            print(f"cli: compress, compress --stream-mb 16, info, decompress, verify, archive, transcode "
                  f"of silesia_like_32MiB in {t_cli:.2f} s, each file equal to the API's; "
                  f"python -m huffman_tpu_torch verify: {r.stdout.strip()} ({card})")

    path_counts.append(run_path("front-end route", FRONT_END_PATH, {}, extra=front_end_route))

    def distributed_route():
        import socket

        import torch.distributed as dist

        from huffman_tpu_torch.ops.tables import tables_from_codebook
        from huffman_tpu_torch.parallel import pipeline as pp

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
        try:
            B = 512
            tabs = {}
            for name, data in (("silesia_like", silesia), ("full_alphabet", full)):
                sym = torch.frombuffer(bytearray(data), dtype=torch.int16).to(dev).reshape(-1, B)
                n_pairs = sym.numel() - 3
                (streams, counts, lengths, ok), t = timed(pp.distributed_encode_streams, sym, n_pairs)
                r = fused.encode_device(sym, n_pairs, 18)
                if not (bool(ok) and torch.equal(streams, r["streams"]) and torch.equal(lengths, r["lengths"])
                        and torch.equal(counts, r["counts"].to(torch.int32))):
                    raise AssertionError(f"distributed_encode_streams [{name}] differs from encode_device")
                if not torch.equal(pp.distributed_histogram(sym.reshape(-1)[:n_pairs]),
                                   cuda_hist.histogram(sym, n_pairs)):
                    raise AssertionError(f"distributed_histogram [{name}] differs from histogram")
                cb = bf.Codebook.from_lengths(lengths.cpu().numpy().astype(np.uint8))
                tabs[name] = (sym, n_pairs, tables_from_codebook(cb, dev), streams)
                print(f"distributed_encode_streams {name}_32MiB, NCCL world 1: {int(counts.sum())} words, "
                      f"{int((lengths > 0).sum())} symbols; median of 3 {t * 1e3:.2f} ms "
                      f"({len(data) / t / 1e9:.3f} GB/s), equal to encode_device ({card})")

            sym, n_pairs, t_full, streams = tabs["full_alphabet"]
            n_real = torch.full((streams.shape[0],), 1024, dtype=torch.int32, device=dev)
            got, t = timed(pp.distributed_decode_groups, streams, n_real, t_full, B, False)
            want = cuda_gather.gather_u16_pairs(
                cuda_decode.decode_groups(streams, n_real, t_full, B, False), t_full.sym_order)
            unpacked = pp.distributed_decode_groups(streams, n_real, t_full, B, False, packed_out=False)
            if not (torch.equal(got, want) and torch.equal(
                    unpacked, cuda_decode.decode_groups(streams, n_real, t_full, B, False, False))):
                raise AssertionError("distributed_decode_groups (rank mode, full alphabet) differs")
            sym_out = got.reshape(streams.shape[0], B // 2, 1024).transpose(1, 2).contiguous()
            if not torch.equal(sym_out.view(torch.int16).reshape(-1)[:n_pairs], sym.reshape(-1)[:n_pairs]):
                raise AssertionError("distributed_decode_groups (rank mode, full alphabet): wrong symbols")
            print(f"distributed_decode_groups full_alphabet_32MiB, rank mode (K1 + K2), NCCL world 1: "
                  f"median of 3 {t * 1e3:.2f} ms ({len(full) / t / 1e9:.3f} GB/s), equal to "
                  f"decode_groups + gather_u16_pairs, unpacked (K5) too ({card})")

            sym, n_pairs, t_sil, _ = tabs["silesia_like"]
            (slab, bits), t_enc = timed(pp.distributed_encode, sym, n_pairs, t_sil, B)
            codes, lens = cuda_gather.gather_table_codes(sym, t_sil, n_pairs)
            if not (torch.equal(slab, cuda_encode.pack_blocks(codes, lens, B))
                    and torch.equal(bits, lens.sum(dim=1, dtype=torch.int32))):
                raise AssertionError("distributed_encode differs from gather_table_codes + pack_blocks")
            out, t_dec = timed(pp.distributed_decode, slab, t_sil, B, repeat=1)
            valid = torch.arange(sym.numel(), device=dev).reshape(sym.shape) < n_pairs
            if not torch.equal(out[valid], (sym.to(torch.int32) & 0xFFFF)[valid]):
                raise AssertionError("distributed_decode: wrong symbols")
            (hist, slab2, bits2, ok), t_step = timed(pp.compress_decompress_step, sym, n_pairs, t_sil, B,
                                                     repeat=1)
            if not (int(ok) == 1 and torch.equal(slab2, slab) and torch.equal(bits2, bits)
                    and torch.equal(hist, cuda_hist.histogram(sym, n_pairs))):
                raise AssertionError("compress_decompress_step differs from the single-device functions")
            print(f"distributed_encode / distributed_decode / compress_decompress_step silesia_like_32MiB "
                  f"(v1 slabs, W={B}), NCCL world 1: {t_enc * 1e3:.2f} ms (median of 3) / "
                  f"{t_dec * 1e3:.1f} ms / {t_step * 1e3:.1f} ms, ok={int(ok)}, equal to the single-device "
                  f"functions ({card})")
        finally:
            dist.destroy_process_group()

    path_counts.append(run_path("distributed route", DISTRIBUTED_PATH, {}, extra=distributed_route))

    def native_route():
        from huffman_tpu_torch.container import reference_format, sharded
        from huffman_tpu_torch.runtime import native

        if not native.available():
            raise AssertionError(f"the native host runtime did not load: {native.load_error()}")
        print(f"native: {native.library_path()}")
        ref = ht.compress_reference(silesia)
        out, t_big = timed(ht.decompress_reference, ref)
        if out != silesia:
            raise AssertionError("native decompress_reference(compress_reference(x)) != x at 32 MiB")
        prefix = silesia[: 1 << 20]
        ref_prefix = ht.compress_reference(prefix)
        out, t_native = timed(ht.decompress_reference, ref_prefix)
        t0 = time.perf_counter()
        loop = reference_format.decompress(ref_prefix)
        t_loop = time.perf_counter() - t0
        if not out == loop == prefix:
            raise AssertionError("native and Python-loop reference decodes differ on the 1 MiB prefix")
        cut = ref_prefix[: len(ref_prefix) // 2]
        errors = []
        for fn in (ht.decompress_reference, reference_format.decompress):
            try:
                fn(cut)
                errors.append(None)
            except Exception as e:  # noqa: BLE001 - the type is the check
                errors.append(e)
        if not (isinstance(errors[0], native.NativeError)
                and str(errors[0]) == "htpu_ref_decompress: truncated input"
                and isinstance(errors[1], (ValueError, EOFError, IndexError))):
            raise AssertionError(f"truncated reference blob: native {errors[0]!r}, loop {errors[1]!r}")
        print(f"native decompress_reference silesia_like_32MiB: median of 3 {t_big:.4f} s "
              f"({len(silesia) / t_big / 1e6:.1f} MB/s); 1 MiB prefix: native {len(prefix) / t_native / 1e6:.1f} "
              f"MB/s, Python loop {len(prefix) / t_loop / 1e6:.3f} MB/s, equal bytes; half the prefix's "
              f"blob: native {type(errors[0]).__name__}({errors[0]}), loop {type(errors[1]).__name__} "
              f"({card})")
        symbols = np.frombuffer(silesia, "<u2", count=len(silesia) // 2)
        hist, t_hist = timed(reference_format.histogram_host, symbols)
        want, t_bincount = timed(np.bincount, symbols, minlength=65536)
        if not np.array_equal(hist, want):
            raise AssertionError("native histogram differs from np.bincount")
        print(f"native histogram_host silesia_like_32MiB: median of 3 {t_hist * 1e3:.2f} ms, "
              f"np.bincount {t_bincount * 1e3:.2f} ms, equal ({card})")
        blob, c = timed(sharded.compress, silesia, n_shards=4, codebook_mode="global")
        out, d = timed(ht.decompress, blob)
        if out != silesia:
            raise AssertionError("HTPX global: decompress(compress(x)) != x")
        print(f"htpx silesia_like_32MiB global, 4 shards, native host histogram: median of 3: compress "
              f"{len(silesia) / c / 1e9:.3f} GB/s, decompress {len(silesia) / d / 1e9:.3f} GB/s ({card})")

    path_counts.append(run_path("native route", NATIVE_PATH, {}, extra=native_route))

    def bench_route():
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        import bench_torch

        t0 = time.perf_counter()
        for r in bench_torch.bench_rung(silesia, "silesia_like_32MB", dev, reps=3):
            print(f"bench {r.json_line()}")
        print(f"bench: silesia_like_32MB rung, 3 repetitions, in {time.perf_counter() - t0:.1f} s")

    path_counts.append(run_path("bench route", BENCH_PATH, {}, extra=bench_route))

    # Last, so that no timing runs after the profiler: the chain of
    # dependent launches of one package-merge call, as device kernels.
    for variant, (rec, args) in k7_args.items():
        rec["profiler_kernels"] = seen = device_kernels(lambda: device_codebook.package_merge(*args))
        print(f"package_merge [{variant}]: dependent launches in one call (torch.profiler "
              f"device kernels) {seen} ({card})")
        if seen == 0:
            raise AssertionError(f"package_merge [{variant}]: the profiler saw no device kernel")

    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(c[name] for c in path_counts), **slowest(records[name])}
        for name, (src, tpu) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
