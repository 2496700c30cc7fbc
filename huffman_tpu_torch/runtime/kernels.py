"""Build, load and launch the port's CUDA kernels.

Counterpart of ``huffman_tpu/runtime/native.py`` for the device side: the
sources in ``huffman_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and link into
ONE shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use into ``runtime/builddir.py``'s directory
(``build/huffman_tpu_torch/`` beside the package where that can be
written), under its lock; the library's file name carries a hash of the
sources and flags, so a stale build is never loaded.

Each C entry point launches one kernel on the stream it is given (PyTorch's
current stream) and returns ``cudaGetLastError()``; ``launch`` raises if
that is not 0 and otherwise adds one to the kernel's launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .builddir import build_dir, locked

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# kernel name -> (C symbol, argument types without the trailing stream)
KERNELS = {
    "decode_groups": (
        "htpu_decode_groups",
        [_P, _I64, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "gather_u16_pairs": ("htpu_gather_u16_pairs", [_P, _I64, _P, _I, _P]),
    "gather_u16": ("htpu_gather_u16", [_P, _I64, _P, _I, _P]),
    "gather_codes": ("htpu_gather_codes", [_P, _I64, _I64, _P, _P, _P]),
    "pack_lanes": ("htpu_pack_lanes", [_P, _P, _I64, _I, _P]),
    "deposit_streams": ("htpu_deposit_streams", [_P, _I, _P, _I, _P, _I, _I, _P]),
    "histogram": ("htpu_histogram", [_P, _I64, _P]),
    "package_merge": (
        "htpu_package_merge",
        [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    ),
    "gather_rank_select": (
        "htpu_gather_rank_select", [_P, _I64, _I64, _P, _P, _P, _I, _P, _P],
    ),
    "gather_rank_canonical": (
        "htpu_gather_rank_canonical",
        [_P, _I64, _I64, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P],
    ),
    "crc32_words": ("htpu_crc32_words", [_P, _I64, _P, _I64]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_launches = dict.fromkeys(KERNELS, 0)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhtpu_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are compiled at first use and need the CUDA toolkit"
    )


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for the current sources exists.
    Returns (library path, compiler output; empty when already built).
    Raises ``RuntimeError`` with the compiler's stderr if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    with locked(BUILD_DIR):
        if lib.exists():  # another process built it while this one waited
            return lib, ""
        return lib, _compile(nvcc, lib)


def _compile(nvcc: str, lib: Path) -> str:
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
            objs.append(str(obj))
        results = [(cmd, p, *p.communicate()) for cmd, p in procs]  # wait for all
        for cmd, p, _, err in results:
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{err}"
                )
        log = [out + err for _, _, out, err in results]
        tmp = work / "lib.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {r.returncode}): {' '.join(cmd)}\n{r.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent load never sees a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return "".join(log)


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in KERNELS.values():
                fn = getattr(lib, symbol)
                fn.argtypes = [*argtypes, _P]
                fn.restype = _I
            lib.htpu_error_string.argtypes = [_I]
            lib.htpu_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(t: torch.Tensor, dtype: torch.dtype, device: torch.device, name: str):
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    on ``device``: the kernels read raw pointers."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device}"
        )


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on PyTorch's current CUDA stream; raise if
    the launch is refused, else count it. Callers keep every tensor whose
    pointer they pass alive until the call returns."""
    lib = load()
    symbol, _ = KERNELS[name]
    rc = getattr(lib, symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.htpu_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    with _lock:  # threads launch at once (the HTPS pipeline): no lost count
        _launches[name] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0
