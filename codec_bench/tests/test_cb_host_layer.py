"""The host container layer's share of a profiled pass: each instant is
counted once, a function outside the codec follows its callers, and the
metric never reads more than the whole pass."""

from __future__ import annotations

import cProfile
import pstats
from pathlib import Path
from types import SimpleNamespace

import pytest

from codec_bench.tests.tiny import ROOT
from codec_bench.run import load_file

READER = load_file(ROOT / "codec_bench" / "metrics" / "host_container_ms_per_GB.py", "host_layer")

LAYER = ("layer.py", 1, "parse")
OTHER = ("other.py", 1, "upload")
SHARED = ("numpy.py", 1, "concatenate")
BACK = ("~", 0, "<built-in method builtins.map>")


def _stats():
    # parse (layer) calls concatenate for 3 s; upload (elsewhere in the
    # codec) calls it for 1 s; map, called from parse, calls back into
    # parse, which the self times count once.
    return {
        LAYER: (2, 2, 4.0, 9.0, {BACK: (1, 1, 4.0, 4.0)}),
        OTHER: (1, 1, 2.0, 3.0, {}),
        SHARED: (2, 2, 4.0, 4.0, {LAYER: (1, 1, 3.0, 3.0), OTHER: (1, 1, 1.0, 1.0)}),
        BACK: (1, 1, 0.5, 4.5, {LAYER: (1, 1, 0.5, 4.5)}),
    }


def test_each_instant_counted_once():
    s = READER.layer_seconds(_stats(), lambda p, n: p == "layer.py", lambda p, n: p == "other.py")
    # parse 4 + concatenate from parse 3 + map from parse 0.5.
    assert s == pytest.approx(7.5)
    assert s <= sum(v[2] for v in _stats().values())


def test_metric_scaled_to_the_window(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "container").mkdir(parents=True)
    (pkg / "container" / "block_format.py").write_text(
        "import zlib\n\ndef work(b):\n    return [zlib.crc32(b) for _ in range(200)]\n")
    (pkg / "glue.py").write_text("def glue(n):\n    return sum(range(n))\n")
    bf = load_file(pkg / "container" / "block_format.py", "bf")
    glue = load_file(pkg / "glue.py", "glue")
    prof = cProfile.Profile()
    prof.enable()
    bf.work(bytes(1 << 16))
    glue.glue(200000)
    prof.disable()
    stats = pstats.Stats(prof)
    t = SimpleNamespace(container="htpu", direction="compress", cprofile=stats,
                        package_dir=Path(pkg), pass_bytes=10**9, pass_wall_s=0.5)
    v = READER.read(t, "compress")
    # At most the whole pass: 500 ms for a GB.
    assert v is not None and 0 < v <= 500.0
    assert READER.read(t, "decompress") is None
