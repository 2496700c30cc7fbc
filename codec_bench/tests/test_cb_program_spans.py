"""The readers of the codec's own spans and counters: self time of nested
``htpu.*`` spans and the card's idle time split by the innermost one, on a
hand-built trace; both counter ratios on a hand-built snapshot; nothing
read for the other direction, an empty root, or a codec that keeps no
spans or counters (an older version of it)."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from codec_bench import counters
from codec_bench.run import load_file
from codec_bench.tests.tiny import ROOT
from codec_bench.tracing import CALL, DeviceTrace

METRICS = ROOT / "codec_bench" / "metrics"
SPANS = load_file(METRICS / "host_span_ms_per_GB.py", "host_span")
PAGEABLE = load_file(METRICS / "pageable_bytes_per_byte.py", "pageable")
FAULTS = load_file(METRICS / "host_faults_per_MB.py", "faults")


def _trace() -> DeviceTrace:
    # Two calls of 10 s. In each: parse 0-2 (a harness range inside it),
    # pad 2-4, upload 4-5 with the copy 4.5-5, decode 5-6 with the kernel
    # 5-7, postpack 6-8, bytes 8-9 holding a nested span 8.2-8.6, crc32 9-9.5;
    # 9.5-10 lies in the root alone.
    host, device = [], []
    for c0 in (0.0, 100.0):
        host.append((CALL, c0, c0 + 10))
        for name, a, b in [("decompress", 0, 10), ("parse", 0, 2), ("pad", 2, 4),
                           ("upload", 4, 5), ("decode", 5, 6), ("postpack", 6, 8),
                           ("bytes", 8, 9), ("inner", 8.2, 8.6), ("crc32", 9, 9.5)]:
            host.append((f"htpu.{name}", c0 + a, c0 + b))
        host.append(("block_format.ParsedContainer", c0 + 0.5, c0 + 1.5))
        device += [("copy", "copy", c0 + 4.5, c0 + 5), ("k1", "kernel", c0 + 5, c0 + 7)]
    calls = [(a, b) for n, a, b in host if n == CALL]
    return DeviceTrace(device, host, calls)


def _traced(trace, direction="decompress", pass_bytes=2 * 10**9, pass_wall_s=10.0):
    return SimpleNamespace(direction=direction, device=trace, pass_bytes=pass_bytes,
                           pass_wall_s=pass_wall_s, package_dir=Path("huffman_tpu_torch"))


def test_self_time_leaves_out_nested_spans():
    own = SPANS.self_seconds(SPANS.program_spans(_trace().host))
    assert own["bytes"] == pytest.approx(2 * 0.6)
    assert own["inner"] == pytest.approx(2 * 0.4)
    assert own["decompress"] == pytest.approx(2 * 0.5)
    assert own["parse"] == pytest.approx(2 * 2.0)  # the harness's range is no program span


@pytest.mark.parametrize("pass_wall_s", [20.0, 10.0, 5.0])
def test_metric_sums_the_host_stages_at_the_windows_pace(capsys, pass_wall_s):
    # parse 2 + pad 2 + bytes 0.6 + crc32 0.5 a call: 51% of the profiled
    # calls' 20 s, scaled to the window's pass of pass_wall_s, per 2 GB.
    v = SPANS.read(_traced(_trace(), pass_wall_s=pass_wall_s), "decompress")
    assert v == pytest.approx(0.51 * pass_wall_s * 1e3 / 2)
    err = capsys.readouterr().err
    assert "over 2 calls" in err and "100.00% of it under program spans" in err
    assert (f"51.00% of the profiled calls' time; unscaled 5100.000 ms/GB in them, scaled to "
            f"the window's pass time {0.51 * pass_wall_s * 1e3 / 2:.3f} ms/GB") in err
    assert SPANS.read(_traced(_trace(), pass_wall_s=0.0), "decompress") is None


def test_idle_split_by_the_innermost_span():
    t = _trace()
    idle = SPANS.idle_by_span(t.gaps(), SPANS.program_spans(t.host))
    # Idle: 0-4.5 (parse, pad, upload 4-4.5), 7-10 (postpack 7-8, bytes,
    # inner, crc32, root), in each call.
    want = {"parse": 2.0, "pad": 2.0, "upload": 0.5, "postpack": 1.0, "bytes": 0.6,
            "inner": 0.4, "crc32": 0.5, "decompress": 0.5}
    assert idle == pytest.approx({k: 2 * v for k, v in want.items()})
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)


def test_idle_no_span_covers():
    t = DeviceTrace([("k", "kernel", 1.0, 2.0)], [(CALL, 0.0, 4.0), ("htpu.decompress", 0.5, 3.0)],
                    [(0.0, 4.0)])
    idle = SPANS.idle_by_span(t.gaps(), SPANS.program_spans(t.host))
    assert idle == pytest.approx({SPANS.UNCOVERED: 1.5, "decompress": 1.5})


SNAPSHOT = {
    "decompress": {"calls": 4, "bytes_in": 80_000_000, "bytes_out": 134_217_728,
                   "h2d_pageable_bytes": 80_000_000, "d2h_pageable_bytes": 134_217_728,
                   "faults": 65_536, "faults.bytes": 32_768},
    "compress": {"calls": 0, "bytes_in": 0, "bytes_out": 0},
}


def test_counter_ratios():
    assert PAGEABLE.value(SNAPSHOT, "decompress") == pytest.approx(
        (80_000_000 + 134_217_728) / 134_217_728)
    assert FAULTS.value(SNAPSHOT, "decompress") == pytest.approx(65_536 / 134.217728)


def test_pages_read_from_the_resident_set_where_no_faults_are_counted():
    root = {k: v for k, v in SNAPSHOT["decompress"].items() if not k.startswith("faults")}
    root |= {"resident_pages": 32_768, "resident_pages.bytes": 16_384}
    assert FAULTS.value({"decompress": root}, "decompress") == pytest.approx(32_768 / 134.217728)
    root.pop("resident_pages")
    assert FAULTS.value({"decompress": root}, "decompress") is None


@pytest.mark.parametrize("reader", [PAGEABLE, FAULTS])
@pytest.mark.parametrize("snapshot,direction", [
    (SNAPSHOT, "compress"),  # a root with no calls
    ({}, "decompress"),      # no root at all
    (None, "decompress"),    # a codec that keeps no counters
])
def test_counter_readers_find_nothing(reader, snapshot, direction):
    assert reader.value(snapshot, direction) is None


@pytest.mark.parametrize("reader", [SPANS, PAGEABLE, FAULTS])
def test_nothing_read_for_the_other_direction(reader):
    assert reader.read(_traced(_trace(), direction="decompress"), "compress") is None


def test_nothing_read_from_a_codec_without_spans_or_counters(tmp_path, monkeypatch):
    (tmp_path / "older_codec" / "utils").mkdir(parents=True)
    for init in ("older_codec/__init__.py", "older_codec/utils/__init__.py"):
        (tmp_path / init).write_text("")
    (tmp_path / "older_codec" / "utils" / "profiling.py").write_text("def trace():\n    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    t = _traced(DeviceTrace([("k", "kernel", 1.0, 2.0)], [(CALL, 0.0, 4.0)], [(0.0, 4.0)]))
    t.package_dir = tmp_path / "older_codec"
    assert counters.snapshot(t) is None
    assert [r.read(t, "decompress") for r in (SPANS, PAGEABLE, FAULTS)] == [None] * 3
    t.package_dir = tmp_path / "no_such_codec"
    assert counters.snapshot(t) is None
