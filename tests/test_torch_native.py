"""The port's native host runtime (huffman_tpu_torch/runtime/native.py over
huffman_tpu_torch/native/htpu_native.cpp) against the JAX package's
(huffman_tpu.runtime.native) and against the port's Python loop: the
reference format's decode (bytes, and the exception type and message on
corrupt blobs), the host histogram and the two-queue code lengths; and
the callers that route through it (``decompress_reference``,
``histogram_host``, ``code_lengths_from_frequencies``).

Both libraries are built with g++ at first use; without g++ the tests
skip (decided in a fixture, so every worker collects the same tests)."""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.runtime import native as jax_native
from huffman_tpu_torch import codebook as torch_codebook
from huffman_tpu_torch.bitio import BitWriter
from huffman_tpu_torch.constants import MAX_SYMBOLS
from huffman_tpu_torch.container import reference_format as rf
from huffman_tpu_torch.corpus import fibonacci_pairs, silesia_like, zipf_pairs
from huffman_tpu_torch.runtime import builddir, native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def libs():
    """Both native libraries, built; skips where g++ is absent."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native runtimes are built at first use")
    assert native.available(), native.load_error()
    assert jax_native.available()


def _cases():
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "one_byte": b"q",
        "one_pair": b"ab",
        "odd_length": zipf_pairs(20_001, 300, np.random.default_rng(1)).tobytes(),
        "constant": b"zz" * 3210,
        "random": rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
        "zipf": zipf_pairs(60_000, 3000, np.random.default_rng(2)).tobytes(),
        "silesia_like": silesia_like(100_000, seed=7).tobytes(),
        "fibonacci_24": fibonacci_pairs(24).tobytes(),  # 23-bit codes
    }


def _foreign_deep_blob() -> tuple[bytes, bytes]:
    """A hand-built reference container with a 40-bit code (lengths 1, 2
    and 40: a prefix code, not complete), as tests/test_torch_reference.py
    builds it, and the bytes it decodes to."""
    w = BitWriter()
    w.write_bytes_aligned(bytes([3, 0, 0]))
    table = {7: (0, 1), 9: (0b10, 2), 11: ((1 << 40) - 1, 40)}
    for sym, (code, length) in table.items():
        w.write(sym, 16)
        w.write(length, 8)
        w.write(code, length)
    seq = [7, 11, 9, 7, 11, 11, 9]
    for i in range(8):
        w.write((2 * len(seq) >> (8 * i)) & 0xFF, 8)
    for s in seq:
        w.write(*table[s])
    return w.getvalue(), np.array(seq, "<u2").tobytes()


def _outcome(fn, blob):
    try:
        return ("ok", fn(blob))
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(_cases()))
def test_decode_matches_jax_native_and_the_loop(libs, name):
    data = _cases()[name]
    blob = huffman_tpu.compress_reference(data)
    assert blob == huffman_tpu_torch.compress_reference(data, "cpu")
    got = native.decompress_reference(blob)
    assert got == data
    assert got == jax_native.decompress_reference(blob)
    assert got == rf.decompress(blob)
    assert huffman_tpu_torch.decompress_reference(blob) == data


def test_decode_29_bit_codes(libs):
    """fibonacci_pairs(): 2,178,308 pairs with codes 1..29 bits deep."""
    data = fibonacci_pairs().tobytes()
    blob = huffman_tpu.compress_reference(data)
    got = huffman_tpu_torch.decompress_reference(blob)
    assert got == data
    assert got == jax_native.decompress_reference(blob)


def test_decode_foreign_codes_deeper_than_32_bits(libs):
    blob, want = _foreign_deep_blob()
    assert native.decompress_reference(blob) == want
    assert jax_native.decompress_reference(blob) == want
    assert rf.decompress(blob) == want


def _corrupt_blobs(n_each: int = 30):
    """Truncated and bit-flipped copies of three reference blobs, from a
    seed: (label, blob)."""
    rng = np.random.default_rng(2024)
    bases = {
        "zipf": huffman_tpu.compress_reference(zipf_pairs(4001, 200, np.random.default_rng(3)).tobytes()),
        "silesia": huffman_tpu.compress_reference(silesia_like(30_000, seed=5).tobytes()),
        "deep": _foreign_deep_blob()[0],
    }
    out = []
    for name, base in bases.items():
        for k in range(n_each):
            if k % 2:
                cut = int(rng.integers(0, len(base)))
                out.append((f"{name}_cut{cut}", base[:cut]))
            else:
                b = bytearray(base)
                for _ in range(int(rng.integers(1, 4))):
                    bit = int(rng.integers(0, 8 * len(b)))
                    b[bit >> 3] ^= 1 << (bit & 7)
                out.append((f"{name}_flip{k}", bytes(b)))
    return out


def test_corrupt_blobs_fail_as_the_jax_package(libs):
    """At least 50 truncated or bit-flipped blobs raise the same exception
    type with the same message in both packages, or decode to the same
    bytes."""
    blobs = _corrupt_blobs()
    assert len(blobs) >= 50
    raised = 0
    for label, blob in blobs:
        ours = _outcome(huffman_tpu_torch.decompress_reference, blob)
        theirs = _outcome(huffman_tpu.decompress_reference, blob)
        assert ours == theirs, label
        raised += ours[0] != "ok"
    assert raised >= 25  # the blobs do exercise the error paths


@pytest.mark.parametrize("cut", [0, 2, 10, "half"])
def test_truncated_blobs_raise_native_error(libs, cut):
    """The probes of the error-type fault: the port now raises NativeError
    (a RuntimeError), with the JAX package's text."""
    blob = huffman_tpu.compress_reference(silesia_like(1 << 16, seed=7).tobytes())
    blob = blob[: len(blob) // 2] if cut == "half" else blob[:cut]
    with pytest.raises(native.NativeError) as ours:
        huffman_tpu_torch.decompress_reference(blob)
    with pytest.raises(jax_native.NativeError) as theirs:
        huffman_tpu.decompress_reference(blob)
    assert isinstance(ours.value, RuntimeError)
    assert str(ours.value) == str(theirs.value)
    assert ours.value.code == theirs.value.code


@pytest.mark.parametrize("n", [0, 1, 2, 3, 100_001, 1 << 19])
def test_histogram_matches_jax_native(libs, n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    got = native.histogram(data)
    assert got.dtype == np.int64 and got.shape == (MAX_SYMBOLS,)
    assert np.array_equal(got, jax_native.histogram(data))
    symbols, _, _ = rf.bytes_to_symbols(data)
    assert np.array_equal(rf.histogram_host(symbols), got)
    assert np.array_equal(np.bincount(symbols, minlength=MAX_SYMBOLS), got)


def _freq_tables():
    rng = np.random.default_rng(3)
    tables = {}
    for n_present in (0, 1, 2, 300, 5000, MAX_SYMBOLS):
        f = np.zeros(MAX_SYMBOLS, dtype=np.int64)
        idx = rng.choice(MAX_SYMBOLS, size=n_present, replace=False)
        f[idx] = np.minimum(rng.zipf(1.3, size=n_present), 1 << 40)
        tables[f"zipf{n_present}"] = f
    fib = np.zeros(MAX_SYMBOLS, dtype=np.int64)  # deeper than 32 bits: the limited rebuild
    a, b = 1, 1
    for s in range(40):
        fib[s * 11] = a
        a, b = b, a + b
    tables["fibonacci40"] = fib
    return tables


@pytest.mark.parametrize("name", sorted(_freq_tables()))
def test_code_lengths_match_jax_native(libs, name, monkeypatch):
    freqs = _freq_tables()[name]
    got = native.code_lengths(freqs)
    assert np.array_equal(got, jax_native.code_lengths(freqs))
    assert np.array_equal(torch_codebook.code_lengths_from_frequencies(freqs), got)
    monkeypatch.setattr(native, "available", lambda: False)  # the Python loop
    assert np.array_equal(torch_codebook.code_lengths_from_frequencies(freqs), got)


def test_negative_counts_raise_native_error_in_both(libs):
    freqs = np.zeros(MAX_SYMBOLS, dtype=np.int64)
    freqs[[3, 9]] = [5, -1]
    with pytest.raises(native.NativeError) as ours:
        huffman_tpu_torch.code_lengths_from_frequencies(freqs)
    with pytest.raises(jax_native.NativeError) as theirs:
        huffman_tpu.code_lengths_from_frequencies(freqs)
    assert str(ours.value) == str(theirs.value) == "htpu_code_lengths: bad arguments"


def test_callers_route_through_the_library(libs, monkeypatch):
    """decompress_reference, histogram_host and dense code lengths call
    the native runtime; a table that is not dense does not."""
    calls = []
    for name in ("decompress_reference", "histogram", "code_lengths"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    data = zipf_pairs(10_000, 100, np.random.default_rng(9)).tobytes()
    blob = huffman_tpu_torch.compress_reference(data, "cpu")
    assert huffman_tpu_torch.decompress_reference(blob) == data
    assert calls == ["histogram", "code_lengths", "decompress_reference"]
    calls.clear()
    assert torch_codebook.code_lengths_from_frequencies(np.array([5, 3, 1])).tolist()[:3] == [1, 2, 2]
    assert calls == []


def test_fallback_without_a_compiler(libs, monkeypatch, tmp_path):
    """Where g++ is missing the library is not available, the reason is
    kept, and decompress_reference takes the Python loop (the JAX
    package's fallback too)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", "")
    monkeypatch.setattr(builddir, "LOCAL_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    assert "g++" in native.load_error() or "FileNotFoundError" in native.load_error()
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="not available"):
        native.histogram(b"abcd")
    data = silesia_like(5000, seed=1).tobytes()
    blob = huffman_tpu.compress_reference(data)
    assert huffman_tpu_torch.decompress_reference(blob) == data
    with pytest.raises(ValueError):  # the loop's error on a 2-byte blob
        huffman_tpu_torch.decompress_reference(blob[:2])


def test_library_name_tracks_source_and_flags(monkeypatch, tmp_path):
    src = tmp_path / "htpu_native.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    before = native.library_path()
    assert before.name.startswith("libhtpu_torch_native_") and before.suffix == ".so"
    assert before.parent == builddir.build_dir()
    with open(src, "a") as f:
        f.write("\n// edited\n")
    edited = native.library_path()
    assert edited != before
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-g"))
    assert native.library_path() not in (before, edited)
    assert before.name != "libhtpu_native.so"  # never the JAX package's library


def test_symbols_stay_local(libs):
    """The library is loaded RTLD_LOCAL: its htpu_histogram is not in the
    process's global symbol scope, where it could bind the kernel
    library's symbol of the same name (or the other way round)."""
    assert native._load() is not None
    with pytest.raises(AttributeError):
        ctypes.CDLL(None).htpu_histogram  # noqa: B018


def test_concurrent_builds_share_one_library(libs, tmp_path):
    """Three processes building into an empty directory at once each load
    a library; one file results, and no temporary file is left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from huffman_tpu_torch.runtime import builddir\n"
        "builddir.LOCAL_BUILD_DIR = Path(sys.argv[1])\n"
        "from huffman_tpu_torch.runtime import native\n"
        "assert native.available(), native.load_error()\n"
        "assert native.decompress_reference(bytes.fromhex(sys.argv[2])) == b'abcab'\n"
        "print(native.library_path())\n"
    )
    blob = huffman_tpu.compress_reference(b"abcab")
    build = tmp_path / "build"
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(build), blob.hex()], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert sorted(p.name for p in build.iterdir() if p.name != ".lock") == [Path(outs[0][0].strip()).name]
