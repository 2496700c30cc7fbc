#!/usr/bin/env python3
"""Where the time of the PyTorch port's compress and decompress goes, on
one CUDA card.

    python3 scripts/torch_profile.py [--mib 32]

For each 32 MiB corpus (silesia-like, wide30k, full-alphabet Zipf), after
a warm-up call:
  * the host-clock wall time of one compress and one decompress, ended by
    ``torch.cuda.synchronize()``;
  * the host functions that take the most of it (``cProfile``, cumulative
    seconds, the top entries of the port's own modules and of the large
    NumPy / zlib / torch calls);
  * the device time per kernel and per copy (``torch.profiler``) and the
    device's busy share of the wall time (sum of device intervals over the
    wall; intervals do not overlap on the one stream the port uses).
Prints the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def host_top(fn, n: int = 12) -> tuple[float, list[str]]:
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = []
    for (file, line, func), (_, _, _, cum, _) in stats.stats.items():
        if "huffman_tpu_torch" in file or func in (
            "crc32", "tobytes", "concatenate", "frombuffer", "to", "cpu", "numpy",
            "lexsort", "synchronize",
        ) or "method" in func:
            rows.append((cum, f"{cum * 1e3:9.2f} ms  {Path(file).name}:{line} {func}"))
    rows.sort(reverse=True)
    return wall, [r for _, r in rows[:n]]


def device_breakdown(fn) -> tuple[float, float, list[str]]:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy = [], 0.0
    for e in prof.key_averages():
        # Device-side events only (kernels, copies, memsets): the CPU ops
        # that launched them carry the same time again.
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            busy += dev_us
            rows.append((dev_us, f"{dev_us / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}"))
    rows.sort(reverse=True)
    return wall, busy / 1e6, [r for _, r in rows[:14]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mib", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import huffman_tpu_torch as ht
    from huffman_tpu_torch.corpus import silesia_like, wide30k, zipf_pairs

    card = card_line()
    print(card)
    n = args.mib << 20
    inputs = {
        "silesia_like": silesia_like(n, seed=7).tobytes(),
        "wide30k": wide30k(n).tobytes(),
        "full_alphabet": zipf_pairs(n, 65536, np.random.default_rng(11)).tobytes(),
    }
    for name, data in inputs.items():
        blob = ht.compress(data)
        assert ht.decompress(blob) == data
        for label, fn in (("compress", lambda: ht.compress(data)),
                          ("decompress", lambda: ht.decompress(blob))):
            wall, top = host_top(fn)
            print(f"\n== {name} {args.mib} MiB {label}: wall {wall * 1e3:.2f} ms "
                  f"(cProfile on) ({card})")
            print("\n".join(top))
            wall, busy, dev = device_breakdown(fn)
            print(f"-- device: busy {busy * 1e3:.3f} ms of {wall * 1e3:.2f} ms wall "
                  f"(torch.profiler on): {100 * busy / wall:.2f}% busy")
            print("\n".join(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
