"""The readers of the resident cell's two metrics, on hand-built counter
snapshots: the host's time a resident call less its blocking read, and the
device bytes held per byte restored; nothing read where the codec keeps no
such counter or no ``load`` root (an older version of it), or for the
other direction."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from codec_bench.run import load_file
from codec_bench.tests.tiny import ROOT
from codec_bench.tracing import CALL, DeviceTrace

METRICS = ROOT / "codec_bench" / "metrics"
ENQUEUE = load_file(METRICS / "host_enqueue_us_per_call.py", "host_enqueue")
HELD = load_file(METRICS / "resident_bytes_per_byte.py", "resident_bytes")


def _trace() -> DeviceTrace:
    # One call of 1.2 ms, its root opening 0.05 ms after the harness's range.
    host = [(CALL, 0.0, 1.3e-3), ("htpu.decompress", 0.05e-3, 1.25e-3),
            ("htpu.wait", 0.4e-3, 1.2e-3)]
    return DeviceTrace([("k1", "kernel", 0.1e-3, 1.1e-3)], host, [(0.0, 1.3e-3)])


def _traced(trace, direction="decompress", package_dir=Path("huffman_tpu_torch")):
    return SimpleNamespace(direction=direction, device=trace, package_dir=package_dir)


def test_enqueue_is_the_root_less_its_wait(monkeypatch):
    # 900 calls whose host time less their wait sums to 315 ms: 350 us each.
    from codec_bench import counters

    monkeypatch.setattr(counters, "snapshot", lambda t: SNAPSHOT)
    assert ENQUEUE.read(_traced(_trace()), "decompress") == pytest.approx(350.0)


def test_enqueue_from_counters_by_hand():
    counts = {"decompress": {"calls": 3, "resident_calls": 2, "host_enqueue_ns": 5000}}
    assert ENQUEUE.value(counts) == pytest.approx(2.5)


@pytest.mark.parametrize("counts,direction,qualifier", [
    ({"decompress": {"calls": 3, "bytes_out": 9}}, "decompress", "decompress"),  # no resident call
    ({"decompress": {"calls": 3, "resident_calls": 3}}, "decompress", "decompress"),  # no counter
    ({}, "decompress", "decompress"),  # no root
    (None, "decompress", "decompress"),  # a codec that keeps no counters
    ({"compress": {"calls": 1, "resident_calls": 1, "host_enqueue_ns": 9}}, "compress",
     "compress"),  # not the decompress root
])
def test_enqueue_reads_nothing(counts, direction, qualifier, monkeypatch):
    from codec_bench import counters

    monkeypatch.setattr(counters, "snapshot", lambda t: counts)
    assert ENQUEUE.read(_traced(_trace(), direction), qualifier) is None


def test_enqueue_reads_nothing_for_the_other_direction(monkeypatch):
    from codec_bench import counters

    monkeypatch.setattr(counters, "snapshot", lambda t: SNAPSHOT)
    assert ENQUEUE.read(_traced(_trace(), "decompress"), "compress") is None
    assert ENQUEUE.read(_traced(_trace(), "compress"), "decompress") is None


SNAPSHOT = {
    "load": {"calls": 2, "resident_bytes": 2 * 258_000_000, "original_bytes": 2 * 268_435_456,
             "h2d_pageable_bytes": 2 * 258_000_000},
    "decompress": {"calls": 900, "resident_calls": 900, "bytes_out": 900 * 268_435_456,
                   "host_enqueue_ns": 900 * 350_000},
}


def test_held_bytes_per_restored_byte():
    assert HELD.value(SNAPSHOT) == pytest.approx(258_000_000 / 268_435_456)


@pytest.mark.parametrize("snapshot", [
    {"decompress": SNAPSHOT["decompress"]},  # no load root: an older codec
    {"load": {"calls": 0, "resident_bytes": 0, "original_bytes": 0}},
    {"load": {"calls": 1, "original_bytes": 5}},  # no held bytes counted
    {},
    None,  # a codec that keeps no counters
])
def test_held_bytes_read_nothing(snapshot):
    assert HELD.value(snapshot) is None


def test_readers_of_a_codec_without_the_resident_store(tmp_path, monkeypatch):
    (tmp_path / "older_codec" / "utils").mkdir(parents=True)
    for init in ("older_codec/__init__.py", "older_codec/utils/__init__.py"):
        (tmp_path / init).write_text("")
    (tmp_path / "older_codec" / "utils" / "profiling.py").write_text(
        "def counters():\n    return {'decompress': {'calls': 3, 'bytes_out': 9}}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    t = _traced(_trace(), package_dir=tmp_path / "older_codec")
    assert HELD.read(t, "") is None
    assert ENQUEUE.read(t, "decompress") is None
    assert HELD.read(_traced(_trace(), "compress", tmp_path / "older_codec"), "") is None
