#!/usr/bin/env python3
"""End-to-end decompress of the bench's 32 MiB inputs against the main
path's forms and glibc's heap, on one CUDA card:

    python3 scripts/torch_decompress_ab.py [--pairs N] [--parent DIR]

1. In one process, ``decompress`` of the same container with the decode
   in rank mode + K2 (the route before the translate boundary was
   measured) and in translate mode, alternating, 14 calls each, on the
   silesia-like, wide30k and full-alphabet inputs: the decode route's
   share of a call.
2. ``N`` rounds (default 3) of fresh processes, one a variant each, in
   turns (the order reversed every other round). Each process runs
   ``compress`` of wide30k 8 times and then ``decompress`` 8 times (the
   first of each a warm-up) and prints the median rates, the decompress
   loop's user and system CPU seconds, and after compress and after
   decompress glibc's heap (``mallinfo2``: mmapped blocks, the main arena,
   its free bytes and the releasable top) and its mmap threshold. The
   threshold is probed in a forked child (so the probe leaves the
   process's heap as it was): the smallest of a ladder of sizes that
   ``malloc`` serves by ``mmap`` (the chunk's IS_MMAPPED bit). The
   variants:
   - ``this``: this tree's forms (streams by K4 + K10, decode in
     translate mode);
   - ``this, tensor-op streams``, ``this, rank + K2 decode`` and ``this,
     both``: the parent's forms put back, one or both;
   - ``parent`` (with ``--parent DIR``, the parent commit's tree, e.g.
     ``git archive`` into a git-ignored directory): its own code;
   - ``this`` and ``parent`` with glibc's threshold fixed by the
     environment (which turns its dynamic raise off): at 128 KiB (glibc's
     initial value: every buffer of 128 KiB or more is a fresh mapping)
     and at 32 MiB with a 64 MiB trim threshold (buffers under 32 MiB
     reuse the heap);
   - ``this`` with the threshold fixed at 30 MiB (about where the
     dynamic raise puts it, above the 28 MiB probe) and the trim
     threshold at 60 MiB (twice it, as the dynamic raise sets it) or at
     1 GiB (the arena's top is never given back to the kernel).
   ``--variants "a;b"`` runs only the named ones.

Prints the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BIG = 32 << 20
LOW = {"MALLOC_MMAP_THRESHOLD_": str(128 << 10)}
HIGH = {"MALLOC_MMAP_THRESHOLD_": str(32 << 20), "MALLOC_TRIM_THRESHOLD_": str(64 << 20)}
TRIM = {"MALLOC_MMAP_THRESHOLD_": str(30 << 20), "MALLOC_TRIM_THRESHOLD_": str(60 << 20)}
KEEP = {"MALLOC_MMAP_THRESHOLD_": str(30 << 20), "MALLOC_TRIM_THRESHOLD_": str(1 << 30)}
PROBE_SIZES = [s << 10 for s in (128, 256, 512, 1024, 2048, 4096, 8192, 12288, 16384, 20480, 24576,
                                 26624, 28672, 30720, 32767)]


class MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in ("arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
                                                "fsmblks", "uordblks", "fordblks", "keepcost")]


def _libc():
    libc = ctypes.CDLL("libc.so.6")
    libc.mallinfo2.restype = MallInfo2
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    return libc


def mmap_threshold() -> str:
    """glibc's mmap threshold as the interval of the probe ladder it lies
    in, probed in a forked child."""
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        libc, prev, text = _libc(), 0, f"> {PROBE_SIZES[-1] >> 10} KiB"
        for size in PROBE_SIZES:
            p = libc.malloc(size)
            mapped = ctypes.c_size_t.from_address(p - 8).value & 2  # IS_MMAPPED
            libc.free(p)
            if mapped:
                text = f"{prev >> 10}..{size >> 10} KiB"
                break
            prev = size
        os.write(w, text.encode())
        os._exit(0)
    os.close(w)
    text = os.read(r, 200).decode()
    os.close(r)
    os.waitpid(pid, 0)
    return text


def heap() -> str:
    import torch

    m = _libc().mallinfo2()
    return (f"glibc mmapped {m.hblks} blocks {m.hblkhd >> 20} MiB, arena {m.arena >> 20} MiB, free "
            f"{m.fordblks >> 20} MiB, top {m.keepcost >> 20} MiB, mmap threshold {mmap_threshold()}; cuda reserved "
            f"{torch.cuda.memory_reserved() >> 20} MiB")


def rank_decode(streams, n_real, tables, B, translate):
    """The v2 decode as it ran before the translate boundary was measured:
    K1's ranks, then K2."""
    from huffman_tpu_torch.ops import cuda_decode, cuda_gather

    return cuda_gather.gather_u16_pairs(cuda_decode.decode_groups(streams, n_real, tables, B, False),
                                        tables.sym_order)


def alternate(card: str) -> None:
    from unittest import mock

    import numpy as np
    import torch

    import huffman_tpu_torch as htt
    from huffman_tpu_torch.container import block_format as bf
    from huffman_tpu_torch.corpus import silesia_like, wide30k, zipf_pairs

    for name, data in (("silesia_like", silesia_like(BIG, seed=7).tobytes()), ("wide30k", wide30k(BIG).tobytes()),
                       ("full_alphabet", zipf_pairs(BIG, 65536, np.random.default_rng(11)).tobytes())):
        blob = htt.compress(data, "cuda")
        times = {"rank": [], "translate": []}
        for r in range(14):
            for route in (("rank", "translate") if r % 2 == 0 else ("translate", "rank")):
                with mock.patch.object(bf, "decode_groups", rank_decode if route == "rank" else bf.decode_groups):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = htt.decompress(blob, "cuda")
                    torch.cuda.synchronize()
                    times[route].append(time.perf_counter() - t0)
                if out != data:
                    raise AssertionError(f"{name}: decompress(compress(x)) != x")
        print(f"one process {name}: decompress ms median [fastest, slowest] over 14, rank + K2 "
              + ", translate ".join(f"{statistics.median(v) * 1e3:.2f} [{min(v) * 1e3:.2f}, {max(v) * 1e3:.2f}]"
                                    for v in times.values()) + f" ({card})", flush=True)


def fresh(variant: str, card: str) -> None:
    """One variant's compress x8 then decompress x8 of wide30k in this
    (fresh) process; ``sys.path[0]`` is the tree under test."""
    import torch

    import huffman_tpu_torch as htt
    from huffman_tpu_torch.corpus import wide30k
    from huffman_tpu_torch.utils.timing import wall_times

    if "tensor-op" in variant or "both" in variant:
        import chip_smoke as cs
        from huffman_tpu_torch.container import block_format as bf
        from huffman_tpu_torch.ops import fused

        fused.encode_streams = bf.encode_streams = cs.encode_streams_tensor_ops
    if "rank" in variant or "both" in variant:
        from huffman_tpu_torch.container import block_format as bf

        bf.decode_groups = rank_decode
    data = wide30k(BIG).tobytes()
    blob = htt.compress(data, "cuda")
    c = wall_times(htt.compress, data, "cuda", iters=7)
    h0 = heap()
    t0 = os.times()
    d = wall_times(htt.decompress, blob, "cuda", iters=7)
    t1 = os.times()
    if htt.decompress(blob, "cuda") != data:
        raise AssertionError(f"{variant}: decompress(compress(x)) != x")
    print(f"fresh process [{variant}]: compress {len(data) / statistics.median(c) / 1e9:.3f} GB/s, "
          f"decompress {len(data) / statistics.median(d) / 1e9:.3f} GB/s; decompress loop user "
          f"{t1.user - t0.user:.2f} s, system {t1.system - t0.system:.2f} s; after compress: {h0}; after decompress: {heap()} "
          f"({card}; {torch.__version__})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--parent", type=Path, help="the parent commit's tree, for the parent's variants")
    ap.add_argument("--variants", help="names of the variants to run, separated by ';' (default: all)")
    ap.add_argument("--fresh", help=argparse.SUPPRESS)
    ap.add_argument("--tree", type=Path, default=ROOT, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.tree.resolve()))
    import torch

    from huffman_tpu_torch.utils.benchmark import device_line

    if not torch.cuda.is_available():
        print("torch_decompress_ab: no CUDA card", file=sys.stderr)
        return 2
    card = device_line(torch.device("cuda"))
    if opts.fresh:
        fresh(opts.fresh, card)
        return 0
    print(card, flush=True)
    variants = [("this", ROOT, {}), ("this, tensor-op streams", ROOT, {}), ("this, rank + K2 decode", ROOT, {}),
                ("this, both", ROOT, {}), ("this, threshold fixed at 128 KiB", ROOT, LOW),
                ("this, threshold fixed at 32 MiB", ROOT, HIGH), ("this, threshold 30 MiB, trim 60 MiB", ROOT, TRIM),
                ("this, threshold 30 MiB, trim 1 GiB", ROOT, KEEP)]
    if opts.parent:
        variants += [("parent", opts.parent, {}), ("parent, threshold fixed at 128 KiB", opts.parent, LOW),
                     ("parent, threshold fixed at 32 MiB", opts.parent, HIGH)]
    if opts.variants:
        names = opts.variants.split(";")
        variants = [v for v in variants if v[0] in names]
    else:
        alternate(card)
    for i in range(opts.pairs):
        for variant, tree, env in (variants if i % 2 == 0 else variants[::-1]):
            subprocess.run([sys.executable, __file__, "--fresh", variant, "--tree", str(tree)],
                           env={**os.environ, **env}, check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
