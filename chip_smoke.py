#!/usr/bin/env python3
"""Smoke test of the PyTorch port (huffman_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or a few:
  0. card: ``nvidia-smi --query-gpu=name,power.limit`` as the card reports it;
  1. build: the four kernels from huffman_tpu_torch/csrc/ with nvcc
     (the package's own first-use build), with the build seconds;
  2. each kernel against its plain PyTorch version on the same CUDA
     tensors, bit for bit, at the shapes of the main path: the tensors are
     captured from compress/decompress of the 32 MiB silesia-like corpus
     (decode in rank mode + the rank -> symbol gather) and of a 300-symbol
     input (decode in translate mode). Times from CUDA events;
  3. the slice: compress on the card, decompress on the card, for the
     32 MiB silesia-like and wide-alphabet (30,000-symbol) corpora, an
     8 MiB 300-symbol input and small edge inputs. Each container must
     equal the one the port's CPU path (the plain versions, held equal to
     the JAX package by the CPU tests) writes, and each decompress must
     return the input. All four kernels must have launched in this phase.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Without a CUDA card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
SILESIA_BYTES = 32 << 20
TRANSLATE_BYTES = 8 << 20

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "decode_groups": ("huffman_tpu_torch/csrc/decode.cu", "huffman_tpu/ops/pallas_decode.py:242"),
    "gather_u16_pairs": ("huffman_tpu_torch/csrc/gather.cu", "huffman_tpu/ops/pallas_gather.py:592"),
    "gather_codes": ("huffman_tpu_torch/csrc/gather.cu", "huffman_tpu/ops/pallas_gather.py:138"),
    "pack_lanes": ("huffman_tpu_torch/csrc/pack.cu", "huffman_tpu/ops/pallas_encode.py:39"),
}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(calls: list[tuple[object, str]], fn, *args):
    """Run ``fn(*args)``; return its result and the arguments of the first
    call of each wrapper ``module.name`` in ``calls`` during it."""
    seen, originals = {}, {}
    for mod, name in calls:
        originals[(mod, name)] = orig = getattr(mod, name)

        def recorder(*a, _orig=orig, _name=name):
            seen.setdefault(_name, a)
            return _orig(*a)

        setattr(mod, name, recorder)
    try:
        result = fn(*args)
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)
    return result, seen


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import huffman_tpu_torch as ht
    from huffman_tpu_torch.container import block_format as bf
    from huffman_tpu_torch.corpus import silesia_like, wide30k, zipf_pairs
    from huffman_tpu_torch.ops import cuda_decode, cuda_encode, cuda_gather
    from huffman_tpu_torch.runtime import kernels

    dev = torch.device(DEVICE)
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib, log = kernels.build()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    silesia = silesia_like(SILESIA_BYTES, seed=7).tobytes()
    small = zipf_pairs(TRANSLATE_BYTES, 300, np.random.default_rng(5)).tobytes()

    # Phase 2: kernel vs plain at the main path's shapes.
    blob, enc = capture(
        [(bf, "gather_codes"), (cuda_encode, "pack_lanes")], ht.compress, silesia, dev
    )
    _, dec = capture([(bf, "decode_groups"), (bf, "gather_u16_pairs")], ht.decompress, blob, dev)
    _, dec_tr = capture([(bf, "decode_groups")], ht.decompress, ht.compress(small, dev), dev)
    assert not dec["decode_groups"][4] and dec_tr["decode_groups"][4], "decode modes"
    checks = [
        ("gather_codes", cuda_gather.gather_codes, cuda_gather.gather_codes_plain, enc["gather_codes"], 20, 3),
        ("pack_lanes", cuda_encode.pack_lanes, cuda_encode.pack_lanes_plain, enc["pack_lanes"], 10, 2),
        ("decode_groups", cuda_decode.decode_groups, cuda_decode.decode_groups_plain, dec["decode_groups"], 5, 2),
        ("gather_u16_pairs", cuda_gather.gather_u16_pairs, cuda_gather.gather_u16_pairs_plain, dec["gather_u16_pairs"], 20, 3),
        ("decode_groups[translate]", cuda_decode.decode_groups, cuda_decode.decode_groups_plain, dec_tr["decode_groups"], 5, 2),
    ]
    records = {}
    for name, kernel, plain, args, iters, plain_iters in checks:
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: kernel(*args), iters)
        plain_ms = cuda_ms(lambda: plain(*args), plain_iters)
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        print(f"kernel {name}: shapes {shapes} max_abs_err {err} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms ({card})")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version")
        base = name.split("[")[0]
        if base not in records:
            records[base] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        else:
            records[base]["max_abs_err"] = max(records[base]["max_abs_err"], err)

    # Phase 3: the slice, counting launches.
    inputs = {
        "silesia_like_32MiB": silesia,
        "wide30k_32MiB": wide30k(SILESIA_BYTES).tobytes(),
        "zipf300_8MiB": small,
        "odd_length": small[: (1 << 20) + 1],
        "one_byte": b"\x01",
        "empty": b"",
        "random_bytes": np.random.default_rng(1).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
    }
    kernels.reset_launch_counts()
    for name, data in inputs.items():
        times_c, times_d = [], []
        for _ in range(3 if len(data) >= TRANSLATE_BYTES else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = ht.compress(data, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = ht.decompress(blob, dev)
            torch.cuda.synchronize()
            times_c.append(t1 - t0)
            times_d.append(time.perf_counter() - t1)
            if out != data:
                raise AssertionError(f"{name}: decompress(compress(x)) != x")
        if blob != ht.compress(data, "cpu"):
            raise AssertionError(f"{name}: card container differs from the CPU path's")
        c, d = statistics.median(times_c), statistics.median(times_d)
        gbps = (f"compress {len(data) / c / 1e9:.3f} GB/s, decompress "
                f"{len(data) / d / 1e9:.3f} GB/s" if len(data) >= TRANSLATE_BYTES else
                f"compress {c * 1e3:.1f} ms, decompress {d * 1e3:.1f} ms")
        print(f"slice {name}: {len(data)} B -> {len(blob)} B (ratio "
              f"{len(blob) / max(len(data), 1):.4f}); median of {len(times_c)}: "
              f"{gbps} ({card})")
    counts = kernels.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": counts[name], **records[name]}
        for name, (src, tpu) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
