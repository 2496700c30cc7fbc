"""The port's command line against the JAX package's: every verb runs
through ``huffman_tpu.cli`` (``--backend numpy``) and
``huffman_tpu_torch.cli`` (``--device cpu``) on the same file, each in a
directory of its own, and the two must agree on exit codes, standard
output and error, and every file written, byte for byte."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from huffman_tpu import cli as jax_cli
from huffman_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
NO_DEVICE_FLAG = ("info",)
_TIMES = re.compile(r"took [0-9.]+ ms(, [0-9.]+ MB/s)?")  # --time and verify lines


def _sample() -> bytes:
    rng = np.random.default_rng(11)
    # Compressible with an odd tail.
    return (rng.zipf(1.5, size=20001) % 200).astype(np.uint8).tobytes()


def _run(main, flag, d: Path, steps, capsys, monkeypatch):
    """Run ``steps`` (argv lists) in ``d``; returns each step's (exit
    code, stdout, stderr) and every file in ``d`` afterwards."""
    monkeypatch.chdir(d)
    results = []
    for argv in steps:
        argv = list(argv) + ([] if argv[0] in NO_DEVICE_FLAG else flag)
        rc = main(argv)
        cap = capsys.readouterr()
        results.append((argv[0], rc, cap.out, _TIMES.sub("took T", cap.err)))
    return results, {p.name: p.read_bytes() for p in sorted(d.iterdir())}


SCENARIOS = {
    "archive_extract_and_collision": [
        ["archive", "s.bin"], ["extract", "s.bin.compressed"],
        ["extract", "s.bin.compressed"], ["info", "s.bin.compressed"],
        ["verify", "s.bin.compressed"],
    ],
    "compress_decompress_and_collision": [
        ["compress", "s.bin"], ["decompress", "s.bin.htpu"], ["info", "s.bin.htpu"],
        ["verify", "s.bin.htpu"],
    ],
    "blocks": [
        ["compress", "s.bin", "-o", "x.htpu", "--mode", "blocks", "--block-symbols", "64"],
        ["decompress", "x.htpu", "-o", "x.out"], ["info", "x.htpu"], ["verify", "x.htpu"],
    ],
    "shards": [
        ["compress", "s.bin", "-o", "x.htpx", "--shards", "3"], ["info", "x.htpx"],
        ["verify", "x.htpx"], ["decompress", "x.htpx", "-o", "x.out"],
    ],
    "stream": [
        ["compress", "s.bin", "-o", "x.htps", "--stream-mb", "1"], ["info", "x.htps"],
        ["verify", "x.htps"], ["decompress", "x.htps"],
    ],
    "transcode": [
        ["archive", "s.bin", "-o", "f.compressed"],
        ["transcode", "f.compressed", "-o", "f.htpu"],
        ["decompress", "f.htpu", "-o", "f.out"],
        ["transcode", "f.htpu", "--to", "reference", "-o", "f2.compressed"],
        ["transcode", "f2.compressed"],
    ],
    "errors": [
        ["archive", "nope"], ["decompress", "nope.htpu"],
        ["compress", "s.bin", "-o", "x", "--stream-mb", "1", "--shards", "3"],
        ["compress", "s.bin", "--time"],
    ],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verbs_match_the_jax_cli(name, tmp_path, capsys, monkeypatch):
    results = {}
    for tag, main, flag in (("jax", jax_cli.main, ["--backend", "numpy"]),
                            ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        (d / "s.bin").write_bytes(_sample())
        results[tag] = _run(main, flag, d, SCENARIOS[name], capsys, monkeypatch)
    (jax_steps, jax_files), (port_steps, port_files) = results["jax"], results["port"]
    assert port_steps == jax_steps
    assert port_files.keys() == jax_files.keys()
    for f in jax_files:
        assert port_files[f] == jax_files[f], f
    if name == "errors":
        assert [rc for _, rc, *_ in port_steps] == [1, 1, 2, 0]


def test_corrupt_inputs_exit_2(tmp_path, capsys, monkeypatch):
    """Corrupt HTPU and HTPS files exit 2 in both CLIs; a corrupt stream
    keeps an existing output file."""
    for tag, main, flag in (("jax", jax_cli.main, ["--backend", "numpy"]),
                            ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        (d / "s.bin").write_bytes(_sample())
        (d / "bad.htpu").write_bytes(b"not a container")
        assert main(["decompress", "bad.htpu", *flag]) == 2
        assert main(["compress", "s.bin", "-o", "x.htpu", *flag]) == 0
        blob = bytearray((d / "x.htpu").read_bytes())
        blob[45] ^= 0xFF
        (d / "bad2.htpu").write_bytes(bytes(blob))
        assert main(["verify", "bad2.htpu", *flag]) == 2
        assert main(["compress", "s.bin", "-o", "c.htps", "--stream-mb", "1", *flag]) == 0
        stream = (d / "c.htps").read_bytes()
        (d / "bad.htps").write_bytes(stream[: len(stream) // 2])
        (d / "keep.bin").write_bytes(b"precious")
        assert main(["decompress", "bad.htps", "-o", "keep.bin", *flag]) == 2
        assert (d / "keep.bin").read_bytes() == b"precious"
        assert not (d / "keep.bin.tmp").exists()
        capsys.readouterr()


def test_the_card_is_the_default(tmp_path, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.bin").write_bytes(_sample())
    assert cli.main(["compress", "s.bin", "--device", "cpu"]) == 0
    for argv in (["compress", "s.bin"], ["archive", "s.bin"], ["decompress", "s.bin.htpu"],
                 ["verify", "s.bin.htpu"], ["transcode", "s.bin.htpu"],
                 ["compress", "s.bin", "--stream-mb", "1", "-o", "x.htps"]):
        capsys.readouterr()
        assert cli.main(argv) == 2, argv
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "s.bin(1)").exists()
    assert cli.main(["archive", "missing.bin"]) == 1


def test_module_entry_point(tmp_path):
    """``python -m huffman_tpu_torch``: seven verbs, and a verify."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-m", "huffman_tpu_torch", "--help"],
                       capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    for verb in ("archive", "extract", "compress", "decompress", "info", "verify", "transcode"):
        assert verb in r.stdout
    (tmp_path / "s.bin").write_bytes(_sample())
    assert cli.main(["compress", str(tmp_path / "s.bin"), "--device", "cpu"]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "huffman_tpu_torch", "verify", "s.bin.htpu", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout == "OK: 20001 bytes, CRC32 verified\n"
