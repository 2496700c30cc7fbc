"""Package-level properties of the PyTorch port: it stands alone (no JAX,
nothing of huffman_tpu), refuses a CUDA device it does not have, runs on
the card by default, builds from hashed sources into a writable build
directory (an installed wheel's user cache), counts only real kernel
launches, and exports the JAX package's public names."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import huffman_tpu_torch
from huffman_tpu_torch.device import resolve_device
from huffman_tpu_torch.runtime import kernels

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "huffman_tpu_torch"


def test_port_runs_without_jax():
    """A roundtrip on each compress route loads neither JAX nor any module
    of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import huffman_tpu_torch as ht\n"
        "from huffman_tpu_torch.container import block_format as bf\n"
        "d = np.random.default_rng(0).integers(0, 40, 30001, dtype=np.uint8).tobytes()\n"
        "assert ht.decompress(ht.compress(d, 'cpu', block_symbols=64), 'cpu') == d\n"
        "bf.DEVICE_MIN_PAIRS = 1000\n"
        "fused = []\n"
        "real = bf._compress_v2_fused\n"
        "bf._compress_v2_fused = lambda *a: fused.append(1) or real(*a)\n"
        "assert ht.decompress(ht.compress(d, 'cpu', block_symbols=64), 'cpu') == d\n"
        "assert fused == [1]\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'huffman_tpu')))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_no_jax_import_in_the_package_source():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    offenders = [p for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def test_nothing_of_huffman_tpu_is_imported():
    """The port keeps its own copies of the host code it needs: no module
    of it, and not chip_smoke.py or bench_torch.py, imports huffman_tpu
    (huffman_tpu_torch's own absolute imports are fine)."""
    pattern = re.compile(r"^\s*(import|from)\s+huffman_tpu(?!_torch)\b", re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    offenders = [p for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from huffman_tpu.codebook import Codebook")
    assert pattern.search("import huffman_tpu as ht")
    assert not pattern.search("import huffman_tpu_torch as ht")


def test_copied_corpora_match_the_jax_package():
    bench = pytest.importorskip("huffman_tpu.utils.benchmark")
    from huffman_tpu_torch import corpus

    for n in (1, 4097, 100_001):
        assert corpus.silesia_like(n, seed=3).tobytes() == bench.silesia_like(n, seed=3).tobytes()
        for n_unique in (1, 300, 30000):
            assert (
                corpus.zipf_pairs(n, n_unique, np.random.default_rng(n_unique)).tobytes()
                == bench.zipf_pairs(n, n_unique, np.random.default_rng(n_unique)).tobytes()
            )
    assert corpus.wide30k(5000).tobytes() == bench.zipf_pairs(
        5000, 30000, np.random.default_rng(3)
    ).tobytes()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        huffman_tpu_torch.compress(b"abcd" * 100)
    blob = huffman_tpu_torch.compress(b"abcd" * 100, "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        huffman_tpu_torch.decompress(blob)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        huffman_tpu_torch.compress(b"abcd" * 100, device="cuda")
    blob = huffman_tpu_torch.compress(b"abcd" * 100, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        huffman_tpu_torch.decompress(blob, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_library_name_tracks_the_sources(monkeypatch, tmp_path):
    for src in kernels.CSRC.glob("*.cu"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.library_path()
    assert before == kernels.library_path()
    with open(tmp_path / "pack.cu", "a") as f:
        f.write("\n// edited\n")
    assert kernels.library_path() != before
    assert before.name.startswith("libhtpu_torch_") and before.suffix == ".so"


def test_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    data = np.random.default_rng(1).integers(0, 2000, 20000).astype("<u2").tobytes()
    blob = huffman_tpu_torch.compress(data, "cpu", block_symbols=64)
    assert huffman_tpu_torch.decompress(blob, "cpu") == data
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_cpu_fused_route_launches_no_kernel(monkeypatch):
    from huffman_tpu_torch.container import block_format as bf

    monkeypatch.setattr(bf, "DEVICE_MIN_PAIRS", 1000)
    test_cpu_path_launches_no_kernel()


def test_every_kernel_symbol_has_a_source():
    text = "".join(p.read_text() for p in kernels.CSRC.glob("*.cu"))
    for symbol, _ in kernels.KERNELS.values():
        assert f'extern "C" int {symbol}(' in text


def test_front_ends_and_distribution_run_without_jax():
    """The CLI, HTPS, HTPX and the distribution layer load neither JAX nor
    any module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import huffman_tpu_torch as ht\n"
        "from huffman_tpu_torch import cli\n"
        "from huffman_tpu_torch.container import sharded, streaming\n"
        "from huffman_tpu_torch.parallel import pipeline\n"
        "d = np.random.default_rng(0).integers(0, 40, 30001, dtype=np.uint8).tobytes()\n"
        "assert ht.decompress(ht.compress(d, 'cpu', n_shards=3), 'cpu') == d\n"
        "s = streaming.compress_bytes(d, chunk_bytes=8192, device='cpu')\n"
        "assert ht.decompress(s, 'cpu') == d\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'huffman_tpu')))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_launch_counts_from_several_threads(monkeypatch):
    """Threads launching at once (the HTPS pipeline) lose no count: a
    stub library stands in for the kernels."""
    import threading
    import types

    stub = types.SimpleNamespace(**{sym: (lambda *a: 0) for sym, _ in kernels.KERNELS.values()})
    monkeypatch.setattr(kernels, "_lib", stub)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_launch_counts()
    n_threads, per_thread = 8, 3000
    names = list(kernels.KERNELS)

    def work(i):
        for k in range(per_thread):
            kernels.launch(names[(i + k) % 2])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert counts[names[0]] + counts[names[1]] == n_threads * per_thread
    assert counts[names[0]] == counts[names[1]] == n_threads * per_thread // 2


def test_public_surface_matches_the_jax_package():
    """code_lengths_from_frequencies, __version__ and
    Codebook.expected_bits are public in the port and agree with the JAX
    package's."""
    import huffman_tpu

    assert huffman_tpu_torch.__version__ == huffman_tpu.__version__
    assert "code_lengths_from_frequencies" in huffman_tpu_torch.__all__
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 700, 65536):
        freqs = np.zeros(65536, dtype=np.int64)
        freqs[rng.choice(65536, n, replace=False)] = rng.integers(1, 10_000, n)
        lengths = huffman_tpu_torch.code_lengths_from_frequencies(freqs)
        assert np.array_equal(lengths, huffman_tpu.code_lengths_from_frequencies(freqs))
        ours = huffman_tpu_torch.Codebook.from_lengths(lengths)
        theirs = huffman_tpu.Codebook.from_lengths(lengths)
        assert ours.expected_bits(freqs) == theirs.expected_bits(freqs)
        assert isinstance(ours.expected_bits(freqs), int)


def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    """The libraries build beside the package where that can be written,
    else into $XDG_CACHE_HOME/huffman_tpu_torch, else
    ~/.cache/huffman_tpu_torch."""
    from huffman_tpu_torch.runtime import builddir, native

    assert kernels.BUILD_DIR == builddir.build_dir() == builddir.LOCAL_BUILD_DIR
    assert builddir.LOCAL_BUILD_DIR == REPO / "build" / "huffman_tpu_torch"
    assert native.library_path().parent == builddir.LOCAL_BUILD_DIR
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")  # a file where the directory's parent would be
    monkeypatch.setattr(builddir, "LOCAL_BUILD_DIR", blocker / "build" / "huffman_tpu_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert builddir.build_dir() == tmp_path / "xdg" / "huffman_tpu_torch"
    assert native.library_path().parent == tmp_path / "xdg" / "huffman_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert builddir.build_dir() == tmp_path / "home" / ".cache" / "huffman_tpu_torch"
    assert not (tmp_path / "home").exists()  # choosing creates nothing


def _world_traversable(path: Path) -> bool:
    return all(os.stat(p).st_mode & 0o001 for p in (path, *path.parents))


def test_installed_wheel_builds_the_native_runtime_into_the_user_cache(tmp_path):
    """A wheel of the repository, installed with --target into a directory
    then made read-only, builds the port's native runtime into
    $XDG_CACHE_HOME/huffman_tpu_torch on first use and decodes a reference
    blob with it. Run as root, the probe runs as user nobody, for whom the
    read-only mode holds."""
    import shutil
    import tempfile

    import huffman_tpu

    if shutil.which("g++") is None:
        pytest.skip("no g++: the native runtime is built at first use")
    root = os.geteuid() == 0
    # The wheel is built, as tests/test_wheel.py builds it, from a copy of
    # the packaging files: two pip builds in one source tree share its build/.
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "setup.py", "MANIFEST.in", "README.md", "Makefile"):
        shutil.copy2(REPO / name, src / name)
    (src / "docs").mkdir()
    shutil.copy2(REPO / "docs" / "FORMATS.md", src / "docs" / "FORMATS.md")
    for name in ("native", "huffman_tpu", "huffman_tpu_torch"):
        shutil.copytree(REPO / name, src / name, ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "-w", str(tmp_path / "dist"), str(src)],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("huffman_tpu-*.whl")

    base = Path(tempfile.mkdtemp())
    try:
        base.chmod(0o755)
        if root and not _world_traversable(base):
            pytest.skip(f"{base.parent} is closed to other users: no unprivileged probe")
        site, cache = base / "site", base / "cache"
        r = subprocess.run(
            [sys.executable, "-m", "pip", "install", "--no-deps", "--target", str(site), str(wheel)],
            capture_output=True, text=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert (site / "huffman_tpu_torch" / "native" / "htpu_native.cpp").exists()
        subprocess.run(["chmod", "-R", "a-w", str(site)], check=True)
        cache.mkdir()
        cache.chmod(0o777)
        probe = (
            "import sys; sys.path.insert(0, sys.argv[1])\n"
            "import huffman_tpu_torch as htt\n"
            "from huffman_tpu_torch.runtime import kernels, native\n"
            "assert htt.__file__.startswith(sys.argv[1]), htt.__file__\n"
            "assert native.available(), native.load_error()\n"
            "print(native.library_path())\n"
            "print(kernels.BUILD_DIR)\n"
            "assert htt.decompress_reference(bytes.fromhex(sys.argv[2])) == bytes.fromhex(sys.argv[3])\n"
        )
        data = np.random.default_rng(2).integers(0, 60, 40_001, dtype=np.uint8).tobytes()
        env = {"PATH": os.environ["PATH"], "XDG_CACHE_HOME": str(cache), "HOME": str(cache)}
        r = subprocess.run(
            [sys.executable, "-c", probe, str(site), huffman_tpu.compress_reference(data).hex(), data.hex()],
            capture_output=True, text=True, timeout=120, cwd=str(base), env=env,
            preexec_fn=(lambda: (os.setgid(65534), os.setuid(65534))) if root else None,
        )
        assert r.returncode == 0, r.stderr[-3000:]
        lib, kernel_dir = r.stdout.split()
        assert Path(lib).parent == Path(kernel_dir) == cache / "huffman_tpu_torch"
        assert Path(lib).exists() and not (site / "build").exists()
    finally:
        subprocess.run(["chmod", "-R", "u+w", str(base)], check=False)
        shutil.rmtree(base, ignore_errors=True)
