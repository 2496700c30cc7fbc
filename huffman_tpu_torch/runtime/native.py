"""ctypes bindings for the port's native C++ host runtime: counterpart of
huffman_tpu/runtime/native.py, over the port's own source
``huffman_tpu_torch/native/htpu_native.cpp``.

It holds the host paths that the port runs outside the card: the reference
format's decoder (``decompress_reference``, any prefix code up to 64 bits),
the dense byte-pair histogram and the two-queue code lengths. Each gives
the same results and raises ``NativeError`` with the same text as the JAX
package's library. It needs ``g++``, and no ``nvcc`` and no card.

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC
-shared`` into ``runtime/builddir.py``'s directory, under its lock, as
``libhtpu_torch_native_<hash>.so``, the hash covering the source and the
flags, so a stale build is never loaded. It is loaded with ctypes'
default ``RTLD_LOCAL``: the kernel library exports ``htpu_histogram`` too,
and neither may bind the other's symbol. Where it cannot be built or
loaded, ``available()`` is False and the callers take their Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..constants import MAX_SYMBOLS
from .builddir import build_dir, locked

SOURCE = Path(__file__).resolve().parents[1] / "native" / "htpu_native.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error = ""

_ERRORS = {
    -1: "bad arguments",
    -2: "truncated input",
    -3: "bad code length/codeword",
    -4: "output buffer overflow",
    -5: "decode protocol invariant broken",
}


class NativeError(RuntimeError):
    def __init__(self, fn: str, code: int):
        super().__init__(f"{fn}: {_ERRORS.get(code, f'error {code}')}")
        self.code = code


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"libhtpu_torch_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if none exists for the current source. Raises
    ``OSError`` (no compiler, no writable directory) or
    ``subprocess.CalledProcessError`` (the compiler failed)."""
    lib = library_path()
    if lib.exists():
        return lib
    with locked(lib.parent):
        if not lib.exists():  # another process may have built it meanwhile
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                    check=True, capture_output=True, text=True, timeout=180,
                )
                os.replace(tmp, lib)  # atomic: a load never sees a partial file
            finally:
                tmp.unlink(missing_ok=True)
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))  # RTLD_LOCAL: see the module docstring
        except subprocess.CalledProcessError as e:
            _error = f"g++ failed (exit {e.returncode}): {e.stderr[-2000:]}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        i64 = ctypes.c_int64
        p8 = ctypes.POINTER(ctypes.c_uint8)
        pi64 = ctypes.POINTER(ctypes.c_int64)
        lib.htpu_code_lengths.argtypes = [pi64, p8]
        lib.htpu_code_lengths.restype = ctypes.c_int
        lib.htpu_ref_original_size.argtypes = [p8, i64]
        lib.htpu_ref_original_size.restype = i64
        lib.htpu_ref_decompress.argtypes = [p8, i64, p8, i64, pi64]
        lib.htpu_ref_decompress.restype = ctypes.c_int
        lib.htpu_histogram.argtypes = [p8, i64, pi64]
        lib.htpu_histogram.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> str:
    """Why the library is not available ("" if it is, or was not tried)."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native runtime is not available: {_error}")
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Two-queue optimal code lengths (native twin of
    codebook.code_lengths_from_frequencies, identical tie-breaking)."""
    lib = _require()
    freqs = np.ascontiguousarray(freqs, dtype=np.int64)
    if freqs.shape != (MAX_SYMBOLS,):
        raise ValueError("freqs must be a dense MAX_SYMBOLS table")
    lengths = np.zeros(MAX_SYMBOLS, dtype=np.uint8)
    rc = lib.htpu_code_lengths(_ptr(freqs, ctypes.c_int64), _ptr(lengths, ctypes.c_uint8))
    if rc != 0:
        raise NativeError("htpu_code_lengths", rc)
    return lengths


def histogram(data: bytes | np.ndarray) -> np.ndarray:
    """Dense 65,536-bin int64 histogram of the little-endian byte pairs of
    ``data`` (an odd last byte is not counted)."""
    lib = _require()
    buf = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    freqs = np.zeros(MAX_SYMBOLS, dtype=np.int64)
    rc = lib.htpu_histogram(_ptr(buf, ctypes.c_uint8), buf.size, _ptr(freqs, ctypes.c_int64))
    if rc != 0:
        raise NativeError("htpu_histogram", rc)
    return freqs


def decompress_reference(blob: bytes) -> bytes:
    """Reference container reader/decoder (arbitrary prefix codes)."""
    lib = _require()
    buf = np.frombuffer(blob, dtype=np.uint8)
    size = int(lib.htpu_ref_original_size(_ptr(buf, ctypes.c_uint8), buf.size))
    if size < 0:
        raise NativeError("htpu_ref_original_size", size)
    out = np.empty(max(size, 1), dtype=np.uint8)
    n = ctypes.c_int64(0)
    rc = lib.htpu_ref_decompress(
        _ptr(buf, ctypes.c_uint8), buf.size,
        _ptr(out, ctypes.c_uint8), size, ctypes.byref(n),
    )
    if rc != 0:
        raise NativeError("htpu_ref_decompress", rc)
    return out[: n.value].tobytes()
