#!/usr/bin/env python3
"""A/B times of the port's K1 (decode_groups) and K4 (pack_lanes) kernels
on one CUDA card, and a clock64() split of K1's step.

    python3 scripts/torch_kernel_ab.py [--clock] [NAME=SOURCE.cu ...]

Captures the kernels' arguments from the main-path calls at 32 MiB (the
silesia-like rank-mode decode, the 8 MiB 300-symbol translate-mode decode,
the rank-mode decode repeated to 160 groups, and the silesia-like and
full-alphabet lane packs). Each NAME=SOURCE.cu is another version of
csrc/decode.cu or csrc/pack.cu with the same C entry point (for example a
parent commit's, unpacked with ``git archive``); it is built into its own
library under build/kernel_ab/, must give the package kernel's output bit
for bit, and is timed with it by CUDA events in turns: the given versions,
the package's, the package's again, the given versions in reverse.

``--clock`` builds a copy of csrc/decode.cu with clock64() stamps between
the phases of a step and prints, averaged over warps and steps, the cycles
each phase takes: the decode (length, rank, symbol, shift, ballot), the
wait for the ring's copies, the barrier, and the scan, refill and next
copy; and the output store. The stamps cost time of their own, so the
instrumented kernel's time is printed beside the split.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import huffman_tpu_torch as ht  # noqa: E402
from huffman_tpu_torch.container import block_format as bf  # noqa: E402
from huffman_tpu_torch.corpus import silesia_like, zipf_pairs  # noqa: E402
from huffman_tpu_torch.ops import cuda_decode, cuda_encode  # noqa: E402
from huffman_tpu_torch.runtime import kernels  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
DECODE_ARGS = [P, I64, P, I, P, P, P, I, I, I, I, I, P]
PACK_ARGS = [P, P, I64, I, P]
STAMP = "#define STAMP(i) { const long long now_ = clock64(); acc[i] += now_ - prev; prev = now_; }"
CLOCK_EDITS = [  # (text in csrc/decode.cu, its form in the clock64() copy)
    ("uint32_t* __restrict__ out) {",
     f"uint32_t* __restrict__ out, long long* dbg) {{\n  long long acc[6] = {{}};\n"
     f"  long long prev = clock64();\n{STAMP}"),
    ("  wait_copies<0>();\n  __syncthreads();\n", "  wait_copies<0>();\n  __syncthreads();\n  STAMP(0)\n"),
    ("    if (wl == 0) cnt[warp] = __popc(ballot);\n",
     "    if (wl == 0) cnt[warp] = __popc(ballot);\n    STAMP(1)\n"),
    ("    wait_copies<kAhead - 1>();\n    __syncthreads();\n",
     "    wait_copies<kAhead - 1>();\n    STAMP(2)\n    __syncthreads();\n    STAMP(3)\n"),
    ("    head += total;\n", "    head += total;\n    STAMP(4)\n"),
    ("    *out_g = (lo & 0xFFFFu) | (hi << 16);\n", "    *out_g = (lo & 0xFFFFu) | (hi << 16);\n    STAMP(5)\n"),
    ("  wait_copies<0>();\n}",
     "  wait_copies<0>();\n  if (wl == 0)\n    for (int i = 0; i < 6; ++i) dbg[((int64_t)g * kWarps + warp) * 8 + i] = acc[i];\n}"),
    ("int max_len, void* out, void* stream) {", "int max_len, void* out, void* dbg, void* stream) {"),
    ("      (uint32_t*)out);", "      (uint32_t*)out, (long long*)dbg);"),
    ('extern "C" int htpu_decode_groups', 'extern "C" int clk_decode_groups'),
    ('extern "C" const char* htpu_error_string', 'extern "C" const char* clk_error_string'),
]


def clock_source() -> str:
    src = (kernels.CSRC / "decode.cu").read_text()
    for text, stamped in CLOCK_EDITS:
        if text not in src:
            raise RuntimeError(f"csrc/decode.cu no longer holds {text!r}")
        src = src.replace(text, stamped, 1)
    return src


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {name: subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in sources.items()}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def runner(lib: ctypes.CDLL, kind: str, args, dbg=None):
    """A no-argument call of ``lib``'s kernel on ``args`` into its own
    output tensor; ``dbg`` adds the clock copy's stamp buffer."""
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "decode_groups":
        s, n, t, B, tr = args
        out = torch.empty((s.shape[0], B // 2, 8, 128), dtype=torch.int32, device=s.device)
        fn = lib.clk_decode_groups if dbg is not None else lib.htpu_decode_groups
        fn.argtypes = [*DECODE_ARGS, *([P] if dbg is not None else []), P]
        extra = [dbg.data_ptr()] if dbg is not None else []
        call = lambda: fn(s.data_ptr(), s.shape[1], n.data_ptr(), s.shape[0], t.lj_limit.data_ptr(),
                          t.base.data_ptr(), t.sym_order.data_ptr(), t.sym_order.numel(), int(tr), B,
                          t.min_len, t.max_len, out.data_ptr(), *extra, stream)
    else:
        c, l = args
        out = torch.empty((c.shape[0], c.shape[1] + 1), dtype=torch.int32, device=c.device)
        lib.htpu_pack_lanes.argtypes = [*PACK_ARGS, P]
        call = lambda: lib.htpu_pack_lanes(c.data_ptr(), l.data_ptr(), c.shape[0], c.shape[1], out.data_ptr(), stream)

    def run():
        if call() != 0:
            raise RuntimeError(f"{kind}: launch failed")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    clock = "--clock" in sys.argv[1:]
    given = dict(a.split("=", 1) for a in sys.argv[1:] if a != "--clock")
    card = cs.card_line()
    print(card)
    sources = {name: Path(src) for name, src in given.items()}
    if clock:
        OUT.mkdir(parents=True, exist_ok=True)
        clk = OUT / "decode_clock.cu"
        clk.write_text(clock_source())
        sources["clock"] = clk
    libs = build(sources)
    dev = torch.device("cuda")
    sil = silesia_like(cs.BIG, seed=7).tobytes()
    blob, enc = cs.capture([(cuda_encode, "pack_lanes")], ht.compress, sil, dev)
    full = zipf_pairs(cs.BIG, 65536, np.random.default_rng(11)).tobytes()
    _, enc_full = cs.capture([(cuda_encode, "pack_lanes")], ht.compress, full, dev)
    _, dec = cs.capture([(bf, "decode_groups")], ht.decompress, blob, dev)
    small = zipf_pairs(cs.TRANSLATE_BYTES, 300, np.random.default_rng(5)).tobytes()
    _, dec_tr = cs.capture([(bf, "decode_groups")], ht.decompress, ht.compress(small, dev), dev)
    s, n, *rest = dec["decode_groups"]
    cases = [("decode_groups", "rank mode", dec["decode_groups"]),
             ("decode_groups", "translate mode", dec_tr["decode_groups"]),
             ("decode_groups", "rank mode, 160 groups", (s.repeat(5, 1), n.repeat(5), *rest)),
             ("pack_lanes", "silesia", enc["pack_lanes"]),
             ("pack_lanes", "full", enc_full["pack_lanes"])]
    package = {"decode_groups": cuda_decode.decode_groups, "pack_lanes": cuda_encode.pack_lanes}
    for kind, variant, args in cases:
        fns = {name: runner(libs[name], kind, args) for name in given
               if hasattr(libs[name], "htpu_decode_groups" if kind == "decode_groups" else "htpu_pack_lanes")}
        want = package[kind](*args)
        for name, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} [{kind}, {variant}] differs from the package's kernel")
        fns["package"] = lambda: package[kind](*args)
        order = [*fns, *reversed(fns)]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs.cuda_ms(fns[name], 10))
        print(f"{kind} [{variant}]: " + ", ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)} ms"
                                                   for k, v in times.items()) + f" ({card})")
    if clock:
        for label, args in (("rank mode", dec["decode_groups"]), ("translate mode", dec_tr["decode_groups"])):
            ng, B = args[0].shape[0], args[3]
            dbg = torch.zeros((ng, 32, 8), dtype=torch.int64, device=dev)
            fn = runner(libs["clock"], "decode_groups", args, dbg)
            ms = cs.cuda_ms(fn, 3)
            if not torch.equal(fn(), cuda_decode.decode_groups(*args)):
                raise AssertionError("the clock copy's output differs from the package's kernel")
            d = dbg[:, :, :6].double()
            per = d[:, :, 1:5].sum(dim=(0, 1)) / (ng * 32 * B)
            print(f"clock {label}: {ng} groups, B {B}, lengths {args[2].min_len}..{args[2].max_len}, "
                  f"instrumented kernel {ms:.4f} ms; cycles a warp: setup {d[:, :, 0].mean():.1f}; a step: "
                  f"decode {per[0]:.1f}, copy wait {per[1]:.1f}, barrier {per[2]:.1f}, scan+refill+copy "
                  f"{per[3]:.1f}, store {d[:, :, 5].mean() / B:.1f} ({card})")
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                       capture_output=True, text=True)
    print(f"SM clock, max: {r.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
