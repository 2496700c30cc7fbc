#!/usr/bin/env python3
"""A/B times of the port's K1 (decode_groups), K4 (pack_lanes), K6
(histogram), K7 (package_merge), K9 (gather_rank_canonical) and K10
(deposit_streams) kernels on one CUDA card, and clock64() splits of K1's
step, K7's one-block kernel, K10, K6 and K9.

    python3 scripts/torch_kernel_ab.py [--clock] [--variants] [--only=KIND[,KIND]] [NAME=SOURCE.cu ...]

Captures the kernels' arguments from the main-path calls at 32 MiB (the
silesia-like rank-mode decode, the 8 MiB 300-symbol translate-mode decode,
the rank-mode decode repeated to 160 groups, the silesia-like and
full-alphabet lane packs, the package-merge of the silesia-like, wide30k
and full-alphabet fused compresses and of the fused encode of the 29-bit
Fibonacci input at a 32-bit limit, the deposit of the silesia-like and
full-alphabet deposit paths, the histogram of the silesia-like and
full-alphabet fused compresses, and again on the silesia-like symbols 2
bytes past a 16-byte boundary with n_valid % 8 == 3, and the canonical-rank
gather of the wide30k (rank stage) and full-alphabet (identity) fused
compresses, and again on the wide30k symbols 2 bytes past a 16-byte
boundary with n_valid % 8 == 3). Each NAME=SOURCE.cu is another version of
csrc/decode.cu, csrc/pack.cu, csrc/package_merge.cu, csrc/deposit.cu,
csrc/hist.cu or csrc/rank_gather.cu with the same C entry point (for
example a parent commit's, unpacked with ``git archive``); it is built
into its own library under build/kernel_ab/, must give the package
kernel's output bit for bit, and is timed with it by CUDA events in turns:
the given versions, the package's, the package's again, the given
versions in reverse. Every version, the package's included, is called
through ctypes on the same preallocated tensors. ``--variants`` adds the
forms of K6, K9 and K10 that were measured and not kept (``VARIANTS``,
text edits of the package's sources; K9's: two or four vectors a thread
a step, 512-thread blocks, stores with L2's normal policy, and, timing
only, the loads and stores with no lookup). ``--only`` keeps the cases,
variants and clock splits of the named kernels (``SYMBOLS``' keys).

``--clock`` builds copies of csrc/decode.cu, csrc/package_merge.cu,
csrc/deposit.cu, csrc/hist.cu and csrc/rank_gather.cu with clock64()
stamps. For K1 it prints, averaged over warps and steps, the cycles each
phase of a step takes: the decode (length, rank, symbol, shift, ballot),
the wait for the ring's copies, the barrier, and the scan, refill and next
copy; and the output store. For K7's one-block kernel it prints the cycles
thread 0 spends in each phase: the histogram sweep, the absent scan, the
sort, the leaf keys and first packages, then, summed over the rounds, the
merge-path search, the merge (with the next round's packages) and the
round barrier, and last the count and the lengths. For K10, K6 and K9 it
prints the cycles lane 0 of each warp spends in each phase, averaged over
the warps (``*_CLOCK_PHASES``; K9's: the table prologue, the first loads
and the wait for the tables, then summed over the steps the compute,
which waits for its loads, and the stores). The stamps cost time of their
own, so each instrumented kernel's time is printed beside its split.
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
from huffman_tpu_torch.corpus import fibonacci_pairs, silesia_like, wide30k, zipf_pairs  # noqa: E402
from huffman_tpu_torch.ops import cuda_encode, cuda_gather, cuda_hist, device_codebook, fused  # noqa: E402
from huffman_tpu_torch.runtime import kernels  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
DECODE_ARGS = [P, I64, P, I, P, P, P, I, I, I, I, I, P]
PACK_ARGS = [P, P, I64, I, P]
SYMBOLS = {"decode_groups": "htpu_decode_groups", "pack_lanes": "htpu_pack_lanes",
           "package_merge": "htpu_package_merge", "deposit_streams": "htpu_deposit_streams",
           "histogram": "htpu_histogram", "gather_rank_canonical": "htpu_gather_rank_canonical"}
# The kernel each source's variants and clock copy are for (``--only``).
VARIANT_KIND = {"decode.cu": "decode_groups", "package_merge.cu": "package_merge", "deposit.cu": "deposit_streams",
                "hist.cu": "histogram", "rank_gather.cu": "gather_rank_canonical"}
# K6 reading its input once: each block reads its own share and adds a
# symbol of its peer's bins in the peer's shared memory.
HIST_SINGLE_READ = [
    ("  if (owner == rank) atomicAdd(bins + (s & (kCtaBins - 1)), 1u);",
     "  if (owner == rank) {\n    atomicAdd(bins + (s & (kCtaBins - 1)), 1u);\n  } else {\n"
     "    uint32_t addr;\n    asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\" : \"=r\"(addr)\n"
     "                 : \"r\"((uint32_t)__cvta_generic_to_shared(bins + (s & (kCtaBins - 1)))), \"r\"(owner));\n"
     "    asm volatile(\"red.shared::cluster.add.u32 [%0], %1;\" :: \"r\"(addr), \"r\"(1u) : \"memory\");\n  }"),
    ("  __syncthreads();  // bins zero before any add", "  cg::this_cluster().sync();"),
    ("  __syncthreads();  // every add landed", "  cg::this_cluster().sync();"),
    ("  const int64_t reader = blockIdx.x / kCtas;", "  const int64_t reader = blockIdx.x;"),
    ("  const int64_t stride = gridDim.x / kCtas * (int64_t)kThreads;", "  const int64_t stride = gridDim.x * (int64_t)kThreads;"),
]
# --variants: the forms of K6, K9 and K10 measured and not kept, and K6's
# split into loads and flush and K9's loads and stores alone, as text edits of the package's sources. The
# TIMING_ONLY ones give another output: they are timed, not checked.
TIMING_ONLY = {"hist_loads_only", "hist_no_flush", "k9_copy_only"}
VARIANTS = {
    # The tile's copies issued before the mask words' loads.
    "deposit_tile_first": ("deposit.cu", [
        ("  // The last word's staging, in flight through the block sum and the\n"
         "  // counts (issued after the mask words' loads, which it would delay).\n"
         "  if (w1 > w0) load_tile(tile, staging, row - wl, n_steps, w1 - 1, wl);\n", ""),
        ("  // The slots past the body, in equal shares",
         "  if (w1 > w0) load_tile(tile, staging, row - wl, n_steps, w1 - 1, wl);\n"
         "  // The slots past the body, in equal shares")]),
    "hist_loads_only": ("hist.cu", [
        ("  int64_t i = reader * kThreads + threadIdx.x;", "  uint32_t sink = 0;\n  int64_t i = reader * kThreads + threadIdx.x;"),
        ("    for (int u = 0; u < kUnroll; ++u) count8(v[u], rank, bins);",
         "    for (int u = 0; u < kUnroll; ++u) sink ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;"),
        ("  __syncthreads();  // every add landed", "  if (sink == 0x9E3779B9u) bins[0] = sink;\n  __syncthreads();  // every add landed")]),
    "hist_no_flush": ("hist.cu", [("    if (v) atomicAdd(out + b, v);", "    if (v == 0xFFFFFFFFu) atomicAdd(out + b, v);")]),
    "hist_single_read": ("hist.cu", HIST_SINGLE_READ),
    "hist_single_read_cluster4": ("hist.cu", [*HIST_SINGLE_READ, ("constexpr int kCtas = 2;", "constexpr int kCtas = 4;")]),
    # K9's block shape and symbols a thread a step, its stores through L2's
    # normal policy, and its loads and stores alone (the symbols written
    # as codes).
    "k9_vecs2": ("rank_gather.cu", [("constexpr int kVecs = 8;", "constexpr int kVecs = 2;")]),
    "k9_vecs4": ("rank_gather.cu", [("constexpr int kVecs = 8;", "constexpr int kVecs = 4;")]),
    "k9_threads512": ("rank_gather.cu", [("constexpr int kCanonThreads = 1024;", "constexpr int kCanonThreads = 512;")]),
    "k9_cached_stores": ("rank_gather.cu", [
        ("        __stcs(codes4 + k, make_uint4(", "        codes4[k] = (make_uint4("),
        ("        __stcs(lens4 + k, make_int4(", "        lens4[k] = (make_int4(")]),
    "k9_copy_only": ("rank_gather.cu", [
        ("        packed[e] = canonical<kIdentity>(w[e], s_canon, s_mask, s_cums, cap2, bound, base_l);\n",
         "        packed[e] = w[e];\n")]),
}
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


PM_CLOCK_EDITS = [  # (text in csrc/package_merge.cu, its form in the clock64() copy)
    ("             int32_t* __restrict__ leaf_sym) {\n",
     "             int32_t* __restrict__ leaf_sym, long long* dbg) {\n  long long acc[8] = {};\n"
     "  long long prev_ = clock64();\n" + STAMP.replace("prev", "prev_") + "\n"),
    ("  // The first K - n absent symbols", "  STAMP(0)\n  // The first K - n absent symbols"),
    ("  // Merge sort of the n_leaf keys", "  STAMP(1)\n  // Merge sort of the n_leaf keys"),
    ("  }\n  // Ranks n_leaf .. K - 1", "  }\n  STAMP(2)\n  // Ranks n_leaf .. K - 1"),
    ("  __syncthreads();\n\n  // 2. Rounds.", "  __syncthreads();\n  STAMP(3)\n\n  // 2. Rounds."),
    ("      int i = lo, j = d0 - lo;", "      STAMP(4)\n      int i = lo, j = d0 - lo;"),
    ("    __syncthreads();\n    uint32_t* t = pk;", "    STAMP(5)\n    __syncthreads();\n    STAMP(6)\n    uint32_t* t = pk;"),
    ("  write_lengths(m_level, K, max_len, lengths);\n}\n\nint blocks_for",
     "  write_lengths(m_level, K, max_len, lengths);\n  STAMP(7)\n"
     "  if (threadIdx.x == 0) for (int i = 0; i < 8; ++i) dbg[i] = acc[i];\n}\n\nint blocks_for"),
    ("void* positions, void* lengths, void* leaf_sym,\n                                  void* stream) {",
     "void* positions, void* lengths, void* leaf_sym,\n                                  void* dbg, void* stream) {"),
    ("(int32_t*)leaf_sym);\n    return", "(int32_t*)leaf_sym, (long long*)dbg);\n    return"),
    ('extern "C" int htpu_package_merge', 'extern "C" int clk_package_merge'),
]
DEPOSIT_CLOCK_EDITS = [  # (text in csrc/deposit.cu, its form in the clock64() copy)
    ("int words_per_run, uint32_t* __restrict__ out) {",
     f"int words_per_run, uint32_t* __restrict__ out, long long* dbg) {{\n  long long acc[4] = {{}};\n"
     f"  long long prev = clock64();\n{STAMP}"),
    ("  int top = n_body - __reduce_add_sync(kFull, s_later[wl]);\n",
     "  int top = n_body - __reduce_add_sync(kFull, s_later[wl]);\n  STAMP(0)\n"),
    ("    // Lane j: the fires at steps j .. 31", "    STAMP(1)\n    // Lane j: the fires at steps j .. 31"),
    ("    // The steps in order, last first", "    STAMP(2)\n    // The steps in order, last first"),
    ("      }\n    }\n    top -= __shfl_sync", "      }\n    }\n    STAMP(3)\n    top -= __shfl_sync"),
    ("    for (int i = lane; i < min(top, cap); i += kLanes) body[i] = 0u;\n  }\n}",
     "    for (int i = lane; i < min(top, cap); i += kLanes) body[i] = 0u;\n  }\n"
     "  if (wl == 0)\n    for (int i = 0; i < 4; ++i)\n"
     "      dbg[(((int64_t)g * gridDim.x + q) * kWarps + warp) * 4 + i] = acc[i];\n}"),
    ("cap, per_run, (uint32_t*)out);", "cap, per_run, (uint32_t*)out, (long long*)dbg);"),
    ("int cap, void* out, void* stream) {", "int cap, void* out, void* dbg, void* stream) {"),
    ('extern "C" int htpu_deposit_streams', 'extern "C" int clk_deposit_streams'),
]
DEPOSIT_CLOCK_PHASES = ("zero past the body + later words + carries + block sum", "ballots + counts + 2 barriers",
                        "suffix sums", "walk of the steps")
HIST_CLOCK_EDITS = [  # (text in csrc/hist.cu, its form in the clock64() copy)
    ("int64_t lead, uint32_t* __restrict__ hist) {",
     f"int64_t lead, uint32_t* __restrict__ hist, long long* dbg) {{\n  long long acc[4] = {{}};\n"
     f"  long long prev = clock64();\n{STAMP}"),
    ("  __syncthreads();  // bins zero before any add", "  STAMP(0)\n  __syncthreads();  // bins zero before any add"),
    ("  __syncthreads();  // every add landed", "  STAMP(1)\n  __syncthreads();  // every add landed"),
    ("  uint32_t* out = hist + rank * kCtaBins;", "  STAMP(2)\n  uint32_t* out = hist + rank * kCtaBins;"),
    ("    if (v) atomicAdd(out + b, v);\n  }\n}",
     "    if (v) atomicAdd(out + b, v);\n  }\n  STAMP(3)\n"
     "  if (threadIdx.x % 32 == 0)\n    for (int i = 0; i < 4; ++i) dbg[(blockIdx.x * 32 + threadIdx.x / 32) * 4 + i] = acc[i];\n}"),
    ("n_valid, lead, (uint32_t*)hist);", "n_valid, lead, (uint32_t*)hist, (long long*)dbg);"),
    ("void* hist, void* stream) {", "void* hist, void* dbg, void* stream) {"),
    ('extern "C" int htpu_histogram', 'extern "C" int clk_histogram'),
]
HIST_CLOCK_PHASES = ("zero bins", "count (loads + atomics)", "barrier", "flush")
K9_CLOCK_EDITS = [  # (text in csrc/rank_gather.cu, its form in the clock64() copy)
    ("                      int bulk, uint32_t* __restrict__ codes,\n                      int32_t* __restrict__ lens) {",
     "                      int bulk, uint32_t* __restrict__ codes,\n                      int32_t* __restrict__ lens, "
     f"long long* dbg) {{\n  long long acc[4] = {{}};\n  long long prev = clock64();\n{STAMP}"),
    ("  // 2. Lane j's boundary and base", "  STAMP(0)\n  // 2. Lane j's boundary and base"),
    ("  if (bulk) wait_tables(bar);\n", "  if (bulk) wait_tables(bar);\n  STAMP(1)\n"),
    ("      if (k < n_vec) {\n", "      STAMP(2)\n      if (k < n_vec) {\n"),
    ("(int32_t)(packed[3] >> 26)));\n      }\n", "(int32_t)(packed[3] >> 26)));\n      }\n      STAMP(3)\n"),
    ("      lens[i] = (int32_t)(packed >> 26);\n    }\n  }\n}\n",
     "      lens[i] = (int32_t)(packed >> 26);\n    }\n  }\n  if (lane == 0)\n    for (int i = 0; i < 4; ++i)\n"
     "      dbg[((int64_t)blockIdx.x * (kCanonThreads / 32) + threadIdx.x / 32) * 4 + i] = acc[i];\n}\n"),
    ("void* codes, void* lens,\n    void* stream) {", "void* codes, void* lens,\n    void* dbg, void* stream) {"),
    ("max_len, bulk,\n        (uint32_t*)codes, (int32_t*)lens);", "max_len, bulk,\n        (uint32_t*)codes, (int32_t*)lens, (long long*)dbg);"),
    ('extern "C" int htpu_gather_rank_canonical', 'extern "C" int clk_gather_rank_canonical'),
]
K9_CLOCK_PHASES = ("table prologue (barrier init, ragged words, bulk issue)", "first loads + table wait",
                   "compute (with the wait for its loads)", "stores")
PM_CLOCK_PHASES = ("sweep", "absent scan", "sort", "leaf keys + first packages",
                   "merge-path search", "merge + packages", "round barrier", "count + lengths")


def clock_source(name: str, edits) -> str:
    src = (kernels.CSRC / name).read_text()
    for text, stamped in edits:
        if text not in src:
            raise RuntimeError(f"csrc/{name} no longer holds {text!r}")
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
    keep = None  # scratch the call writes, alive as long as the call
    if kind == "package_merge":
        freqs, n, max_len, K = args
        out = torch.empty((2, K), dtype=torch.int32, device=freqs.device)
        keep, pointers = device_codebook.kernel_scratch(freqs.numel(), K, max_len, freqs.device)
        fn = lib.clk_package_merge if dbg is not None else lib.htpu_package_merge
        fn.argtypes = [*kernels.KERNELS["package_merge"][1], *([P] if dbg is not None else []), P]
        extra = [dbg.data_ptr()] if dbg is not None else []
        call = lambda: fn(freqs.data_ptr(), freqs.numel(), n, K, max_len, *pointers, out.data_ptr(),
                          out.data_ptr() + 4 * K, *extra, stream)
    elif kind == "decode_groups":
        s, n, t, B, tr = args
        out = torch.empty((s.shape[0], B // 2, 8, 128), dtype=torch.int32, device=s.device)
        fn = lib.clk_decode_groups if dbg is not None else lib.htpu_decode_groups
        fn.argtypes = [*DECODE_ARGS, *([P] if dbg is not None else []), P]
        extra = [dbg.data_ptr()] if dbg is not None else []
        call = lambda: fn(s.data_ptr(), s.shape[1], n.data_ptr(), s.shape[0], t.lj_limit.data_ptr(),
                          t.base.data_ptr(), t.sym_order.data_ptr(), t.sym_order.numel(), int(tr), B,
                          t.min_len, t.max_len, out.data_ptr(), *extra, stream)
    elif kind == "deposit_streams":
        st, mask, body, words_cap = args
        cap = -(-words_cap // 1024) * 1024
        out = torch.empty((body.numel(), 2048 + cap), dtype=torch.int32, device=st.device)
        fn = lib.clk_deposit_streams if dbg is not None else lib.htpu_deposit_streams
        fn.argtypes = [*kernels.KERNELS["deposit_streams"][1], *([P] if dbg is not None else []), P]
        extra = [dbg.data_ptr()] if dbg is not None else []
        call = lambda: fn(st.data_ptr(), st.shape[1] - 1, mask.data_ptr(), mask.shape[1], body.data_ptr(),
                          body.numel(), cap, out.data_ptr(), *extra, stream)
    elif kind == "histogram":
        sym, n_valid = args
        # Zeroed once: the first call's counts are checked, the timed calls
        # add to them (the same atomics and bins).
        out = torch.zeros(65536, dtype=torch.int32, device=sym.device)
        fn = lib.clk_histogram if dbg is not None else lib.htpu_histogram
        fn.argtypes = [*kernels.KERNELS["histogram"][1], *([P] if dbg is not None else []), P]
        extra = [dbg.data_ptr()] if dbg is not None else []
        call = lambda: fn(sym.data_ptr(), n_valid, out.data_ptr(), *extra, stream)
    elif kind == "gather_rank_canonical":
        sym, n_valid, maskw, cums, canon16, start, base, max_len, identity = args
        n = sym.numel()
        # codes and lens rows, each 16-byte aligned as the kernel needs
        keep = torch.empty((2, -(-n // 4) * 4), dtype=torch.int32, device=sym.device)
        out = keep[:, :n]
        fn = lib.clk_gather_rank_canonical if dbg is not None else lib.htpu_gather_rank_canonical
        fn.argtypes = [*kernels.KERNELS["gather_rank_canonical"][1], *([P] if dbg is not None else []), P]
        extra = [dbg.data_ptr()] if dbg is not None else []
        call = lambda: fn(sym.data_ptr(), n, n_valid, maskw.data_ptr(), cums.data_ptr(), canon16.data_ptr(),
                          canon16.numel(), start.data_ptr(), base.data_ptr(), max_len, int(identity),
                          keep[0].data_ptr(), keep[1].data_ptr(), *extra, stream)
    else:
        c, l = args
        out = torch.empty((c.shape[0], c.shape[1] + 1), dtype=torch.int32, device=c.device)
        lib.htpu_pack_lanes.argtypes = [*PACK_ARGS, P]
        call = lambda: lib.htpu_pack_lanes(c.data_ptr(), l.data_ptr(), c.shape[0], c.shape[1], out.data_ptr(), stream)

    def run(_keep=keep):
        if call() != 0:
            raise RuntimeError(f"{kind}: launch failed")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    flags = {"--clock", "--variants"}
    clock = "--clock" in sys.argv[1:]
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--only=")]
    only = set(only[0]) if only else set(SYMBOLS)
    given = dict(a.split("=", 1) for a in sys.argv[1:] if a not in flags and not a.startswith("--only="))
    card = cs.card_line()
    print(card)
    sources = {name: Path(src) for name, src in given.items()}
    if "--variants" in sys.argv[1:]:
        OUT.mkdir(parents=True, exist_ok=True)
        for name, (src, edits) in VARIANTS.items():
            if VARIANT_KIND[src] not in only:
                continue
            (OUT / f"{name}.cu").write_text(clock_source(src, edits))
            sources[name] = OUT / f"{name}.cu"
            given[name] = str(sources[name])
    if clock:
        OUT.mkdir(parents=True, exist_ok=True)
        for name, src, edits in (("clock", "decode.cu", CLOCK_EDITS), ("pm_clock", "package_merge.cu", PM_CLOCK_EDITS),
                                 ("deposit_clock", "deposit.cu", DEPOSIT_CLOCK_EDITS),
                                 ("hist_clock", "hist.cu", HIST_CLOCK_EDITS),
                                 ("k9_clock", "rank_gather.cu", K9_CLOCK_EDITS)):
            if VARIANT_KIND[src] not in only:
                continue
            (OUT / f"{name}.cu").write_text(clock_source(src, edits))
            sources[name] = OUT / f"{name}.cu"
    libs = build(sources)
    libs["package"] = kernels.load()
    dev = torch.device("cuda")
    sil = silesia_like(cs.BIG, seed=7).tobytes()
    enc_calls = [(cuda_encode, "pack_lanes"), (device_codebook, "package_merge"), (fused, "histogram"),
                 (cuda_encode, "pack_streams"), (fused, "gather_rank_canonical")]
    blob, enc = cs.capture(enc_calls, ht.compress, sil, dev)
    full = zipf_pairs(cs.BIG, 65536, np.random.default_rng(11)).tobytes()
    _, enc_full = cs.capture(enc_calls, ht.compress, full, dev)
    _, enc_wide = cs.capture(enc_calls, ht.compress, wide30k(cs.BIG).tobytes(), dev)
    raw_fib, fib_pairs = cs.fibonacci_raw(fibonacci_pairs().tobytes())
    _, enc_fib = cs.capture(enc_calls, fused.encode_device_bytes, raw_fib.to(dev), fib_pairs, 512, 32)
    _, dec = cs.capture([(bf, "decode_groups")], ht.decompress, blob, dev)
    small = zipf_pairs(cs.TRANSLATE_BYTES, 300, np.random.default_rng(5)).tobytes()
    _, dec_tr = cs.capture([(bf, "decode_groups")], ht.decompress, ht.compress(small, dev), dev)
    s, n, *rest = dec["decode_groups"]
    deposit = {name: cs.capture([(cuda_encode, "deposit_streams")], cuda_encode.pack_streams_kernel_deposit,
                                *e["pack_streams"])[1]["deposit_streams"]
               for name, e in (("silesia", enc), ("full", enc_full))}
    sym, n_valid = enc["histogram"]
    odd = (sym.reshape(-1)[1:], n_valid - 5)  # 2 bytes past a 16-byte boundary; n_valid % 8 == 3
    sym9, n_valid9, *tables9 = enc_wide["gather_rank_canonical"]
    odd9 = (sym9.reshape(-1)[1:], n_valid9 - 5, *tables9)
    cases = [("decode_groups", "rank mode", dec["decode_groups"]),
             ("decode_groups", "translate mode", dec_tr["decode_groups"]),
             ("decode_groups", "rank mode, 160 groups", (s.repeat(5, 1), n.repeat(5), *rest)),
             ("pack_lanes", "silesia", enc["pack_lanes"]),
             ("pack_lanes", "full", enc_full["pack_lanes"]),
             ("package_merge", "K=4096 silesia", enc["package_merge"]),
             ("package_merge", "K=4096 max_len 32 fibonacci", enc_fib["package_merge"]),
             ("package_merge", "K=32768 wide30k", enc_wide["package_merge"]),
             ("package_merge", "K=65536 full", enc_full["package_merge"]),
             ("deposit_streams", "silesia", deposit["silesia"]),
             ("deposit_streams", "full", deposit["full"]),
             ("histogram", "silesia", enc["histogram"]),
             ("histogram", "full", enc_full["histogram"]),
             ("histogram", "silesia, odd offset and length", odd),
             ("gather_rank_canonical", "rank stage, wide30k", enc_wide["gather_rank_canonical"]),
             ("gather_rank_canonical", "identity, full", enc_full["gather_rank_canonical"]),
             ("gather_rank_canonical", "rank stage, wide30k, odd offset and length", odd9)]
    plain = {"package_merge": lambda *a: torch.stack(device_codebook.package_merge_plain(*a)),
             "deposit_streams": cuda_encode.deposit_streams_plain, "histogram": cuda_hist.histogram_plain,
             "gather_rank_canonical": lambda *a: torch.stack([x.reshape(-1) for x in
                                                              cuda_gather.gather_rank_canonical_plain(*a)])}
    for kind, variant, args in cases:
        if kind not in only:
            continue
        package = runner(libs["package"], kind, args)
        want = package().clone()
        if kind in plain and not torch.equal(want, plain[kind](*args)):
            raise AssertionError(f"the package's kernel [{kind}, {variant}] differs from its plain version")
        fns = {name: runner(libs[name], kind, args) for name in given if hasattr(libs[name], SYMBOLS[kind])}
        for name, fn in fns.items():
            if not torch.equal(fn(), want) and name not in TIMING_ONLY:
                raise AssertionError(f"{name} [{kind}, {variant}] differs from the package's kernel")
        fns["package"] = package
        order = [*fns, *reversed(fns)]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs.cuda_ms(fns[name], 10))
        print(f"{kind} [{variant}]: " + ", ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)} ms"
                                                   for k, v in times.items()) + f" ({card})")
    if clock and "decode_groups" in only:
        for label, args in (("rank mode", dec["decode_groups"]), ("translate mode", dec_tr["decode_groups"])):
            ng, B = args[0].shape[0], args[3]
            dbg = torch.zeros((ng, 32, 8), dtype=torch.int64, device=dev)
            fn = runner(libs["clock"], "decode_groups", args, dbg)
            ms = cs.cuda_ms(fn, 3)
            if not torch.equal(fn(), runner(libs["package"], "decode_groups", args)()):
                raise AssertionError("the clock copy's output differs from the package's kernel")
            d = dbg[:, :, :6].double()
            per = d[:, :, 1:5].sum(dim=(0, 1)) / (ng * 32 * B)
            print(f"clock {label}: {ng} groups, B {B}, lengths {args[2].min_len}..{args[2].max_len}, "
                  f"instrumented kernel {ms:.4f} ms; cycles a warp: setup {d[:, :, 0].mean():.1f}; a step: "
                  f"decode {per[0]:.1f}, copy wait {per[1]:.1f}, barrier {per[2]:.1f}, scan+refill+copy "
                  f"{per[3]:.1f}, store {d[:, :, 5].mean() / B:.1f} ({card})")
    if clock and "package_merge" in only:
        for label, args in (("silesia", enc["package_merge"]), ("fibonacci, max_len 32", enc_fib["package_merge"])):
            dbg = torch.zeros(8, dtype=torch.int64, device=dev)
            fn = runner(libs["pm_clock"], "package_merge", args, dbg)
            ms = cs.cuda_ms(fn, 10)
            if not torch.equal(fn(), runner(libs["package"], "package_merge", args)()):
                raise AssertionError("the clock copy's output differs from the package's kernel")
            fn()
            torch.cuda.synchronize()
            cycles = dict(zip(PM_CLOCK_PHASES, dbg.tolist()))
            print(f"clock package_merge one block [{label}]: K {args[3]}, n {args[1]}, max_len {args[2]}, "
                  f"instrumented kernel {ms:.4f} ms; cycles (thread 0; the rounds' summed over "
                  f"{args[2] - 1} rounds): "
                  + ", ".join(f"{k} {v}" for k, v in cycles.items()) + f" ({card})")
    if clock:
        splits = [("deposit_streams", "deposit_clock", DEPOSIT_CLOCK_PHASES, variant, args)
                  for variant, args in deposit.items()]
        splits += [("histogram", "hist_clock", HIST_CLOCK_PHASES, variant, args)
                   for variant, args in (("silesia", enc["histogram"]), ("full", enc_full["histogram"]))]
        splits += [("gather_rank_canonical", "k9_clock", K9_CLOCK_PHASES, variant, args)
                   for variant, args in (("rank stage, wide30k", enc_wide["gather_rank_canonical"]),
                                         ("identity, full", enc_full["gather_rank_canonical"]))]
        for kind, lib_name, phases, label, args in splits:
            if kind not in only:
                continue
            dbg = torch.zeros((1 << 20, len(phases)), dtype=torch.int64, device=dev)
            fn = runner(libs[lib_name], kind, args, dbg)
            ms = cs.cuda_ms(fn, 10)
            want = runner(libs["package"], kind, args)()
            dbg.zero_()
            fn_once = runner(libs[lib_name], kind, args, dbg)
            if not torch.equal(fn_once(), want):
                raise AssertionError(f"the clock copy's output differs from the package's kernel [{kind}]")
            torch.cuda.synchronize()
            rows = dbg[dbg.sum(dim=1) > 0].double()
            print(f"clock {kind} [{label}]: instrumented kernel {ms:.4f} ms; cycles a warp (mean over "
                  f"{rows.shape[0]} warps, lane 0): " + ", ".join(
                      f"{k} {v:.0f}" for k, v in zip(phases, rows.mean(dim=0).tolist()))
                  + f"; slowest warp {rows.sum(dim=1).max():.0f} ({card})")
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                       capture_output=True, text=True)
    print(f"SM clock, max: {r.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
