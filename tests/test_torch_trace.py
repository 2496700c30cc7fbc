"""The port's own spans and counters (huffman_tpu_torch/utils/profiling.py)
on the CPU: the stages of compress and decompress as ``htpu.*`` ranges
nested in their call's root range under ``torch.profiler``; no range where
no profiler records; the counters after N calls; the rule that counts a
copy's pageable bytes; the span stack under exceptions and threads."""

from __future__ import annotations

import mmap
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import huffman_tpu_torch as ht
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.utils import profiling

CPU = torch.device("cpu")
DECOMPRESS_STAGES = ["parse", "tables", "pad", "upload", "decode", "postpack", "bytes", "crc32"]
HOST_CODEBOOK_STAGES = ["lengths", "header", "crc32", "tables", "upload", "encode", "download",
                        "emit"]
PAGEABLE = ("h2d_pageable_bytes", "d2h_pageable_bytes")


def _data(n_pairs: int = 20000, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, n_pairs) % 3000).astype("<u2").tobytes() + b"\x07"


def _spans(fn) -> list[tuple[str, float, float]]:
    """(name, start, end) of the ``htpu.*`` ranges recorded while ``fn``
    runs under ``torch.profiler``, in order of their start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name[len("htpu."):], e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("htpu.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _first_seen(spans) -> list[str]:
    names: list[str] = []
    for name, _, _ in spans:
        if name not in names:
            names.append(name)
    return names


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _delta(before: dict, after: dict, root: str) -> dict:
    b, a = before.get(root, {}), after.get(root, {})
    return {k: a[k] - b.get(k, 0) for k in a}


@pytest.mark.parametrize("mode,stages", [
    ("interleaved", DECOMPRESS_STAGES),
    ("blocks", DECOMPRESS_STAGES),
    ("stored", ["parse", "crc32"]),
])
def test_decompress_stages_nest_in_their_root(mode, stages):
    if mode == "stored":
        data = np.random.default_rng(5).integers(0, 256, 4000, dtype=np.uint8).tobytes()
        blob = ht.compress(data, device="cpu")
        assert blob[5] & 4  # incompressible: a stored container
    else:
        data = _data()
        blob = ht.compress(data, device="cpu", mode=mode)
    got = []
    spans = _spans(lambda: got.append(ht.decompress(blob, device="cpu")))
    assert got == [data]
    roots = [s for s in spans if s[0] == "decompress"]
    assert len(roots) == 1
    assert _first_seen(spans) == ["decompress"] + stages
    assert all(_inside(s, roots[0]) for s in spans)


@pytest.mark.parametrize("route,mode,stages", [
    ("host_codebook", "interleaved", HOST_CODEBOOK_STAGES),
    ("host_codebook", "blocks", HOST_CODEBOOK_STAGES),
    ("fused", "interleaved", ["upload", "encode", "lengths", "header", "crc32", "download",
                              "emit"]),
])
def test_compress_stages_nest_in_their_root(monkeypatch, route, mode, stages):
    data = _data()
    if route == "fused":
        monkeypatch.setattr(bf, "DEVICE_MIN_PAIRS", 1)
    got = []
    spans = _spans(lambda: got.append(ht.compress(data, device="cpu", mode=mode)))
    monkeypatch.undo()
    assert got == [ht.compress(data, device="cpu", mode=mode)]
    roots = [s for s in spans if s[0] == "compress"]
    assert len(roots) == 1
    assert _first_seen(spans) == ["compress"] + stages
    assert all(_inside(s, roots[0]) for s in spans)
    # The header's CRC32 is a stage of its own inside the header.
    crc = [s for s in spans if s[0] == "crc32"]
    assert crc and all(any(_inside(c, h) for h in spans if h[0] == "header") for c in crc)


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_no_profiler_range_unless_a_profiler_records(monkeypatch, direction):
    data = _data(4000)
    blob = ht.compress(data, device="cpu")
    call = (lambda: ht.compress(data, device="cpu")) if direction == "compress" else \
        (lambda: ht.decompress(blob, device="cpu"))
    real = torch.profiler.record_function
    entered: list[str] = []

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    call()
    assert entered == []
    _spans(call)
    assert f"htpu.{direction}" in entered and len(entered) >= 4


@pytest.mark.parametrize("direction", ["compress", "decompress"])
@pytest.mark.parametrize("n_calls", [1, 3])
def test_counters_after_n_calls(direction, n_calls):
    inputs = [_data(3000 + 1000 * i, seed=i) for i in range(n_calls)]
    if direction == "decompress":
        inputs = [ht.compress(x, device="cpu") for x in inputs]
        call = ht.decompress
    else:
        call = ht.compress
    before = profiling.counters()
    outputs = [call(x, device="cpu") for x in inputs]
    c = _delta(before, profiling.counters(), direction)
    assert c["calls"] == n_calls
    assert c["bytes_in"] == sum(map(len, inputs))
    assert c["bytes_out"] == sum(map(len, outputs))
    memory = profiling._memory_counter()
    pages = {k: v for k, v in c.items() if k.startswith(memory)}
    assert memory in pages and all(v >= 0 for v in pages.values())
    assert all(c.get(k, 0) == 0 for k in PAGEABLE)  # nothing crosses to a card


UPLOAD_BUFFER = ("upload_buffer_hits", "upload_buffer_misses")
DOWNLOAD_BUFFER = ("download_buffer_hits", "download_buffer_misses")


def _buffer_counts(blobs_by_thread: list[list[bytes]],
                   counters: tuple[str, str] = UPLOAD_BUFFER) -> tuple[int, int]:
    """The decompress root's (hits, misses) of one host buffer's
    ``counters`` added while one new thread each (none with a buffer yet)
    decompresses its blobs in turn, the threads at once; every output is
    checked against a decompress made before."""
    want = {b: ht.decompress(b, device="cpu") for blobs in blobs_by_thread for b in blobs}
    start = threading.Barrier(len(blobs_by_thread))
    errors: list[BaseException] = []

    def work(blobs):
        try:
            start.wait()
            for b in blobs:
                assert ht.decompress(b, device="cpu") == want[b]
        except BaseException as e:  # reported by the assertion below
            errors.append(e)

    before = profiling.counters()
    threads = [threading.Thread(target=work, args=(b,)) for b in blobs_by_thread]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    c = _delta(before, profiling.counters(), "decompress")
    return tuple(c.get(k, 0) for k in counters)


@pytest.mark.parametrize("n_calls", [1, 3])
def test_upload_buffer_counters_after_n_calls(n_calls):
    blob = ht.compress(_data(3000), device="cpu")
    assert _buffer_counts([[blob] * n_calls]) == (n_calls - 1, 1)


def test_upload_buffer_misses_when_a_larger_container_comes():
    small, large = (ht.compress(_data(n), device="cpu") for n in (3000, 60000))
    size = [bf.ParsedContainer(b) for b in (small, large)]
    assert size[0].ngroups * size[0].row_words < size[1].ngroups * size[1].row_words
    # The large one grows the buffer; the small one then fits in it.
    assert _buffer_counts([[small, large, small, large]]) == (2, 2)


def test_one_upload_buffer_miss_per_thread():
    blob = ht.compress(_data(3000), device="cpu")
    assert _buffer_counts([[blob] * 3 for _ in range(4)]) == (8, 4)


@pytest.mark.parametrize("calls,want", [
    ("one_call", (0, 1)),
    ("three_calls", (2, 1)),
    ("larger_container_comes", (2, 2)),
    ("eight_threads_at_once", (16, 8)),
])
def test_download_buffer_counters(calls, want):
    """A hit for each decode the thread's download buffer serves as it
    stood, a miss for each that allocates or grows it: one a thread, and
    one more where a container of more groups comes."""
    small, large = (ht.compress(_data(n), device="cpu", block_symbols=16)
                    for n in (3000, 60000))
    assert (bf.ParsedContainer(small).ngroups, bf.ParsedContainer(large).ngroups) == (1, 4)
    blobs_by_thread = {
        "one_call": [[small]],
        "three_calls": [[small] * 3],
        "larger_container_comes": [[small, large, small, large]],
        "eight_threads_at_once": [[small] * 3 for _ in range(8)],
    }[calls]
    assert _buffer_counts(blobs_by_thread, DOWNLOAD_BUFFER) == want


def _tensor(where: str, nbytes: int = 4096):
    """A stand-in with what the rule reads: ``is_cuda``, ``is_pinned()``,
    ``nbytes``; ``where`` is "cuda", "pinned" or "host"."""
    return SimpleNamespace(is_cuda=where == "cuda", nbytes=nbytes,
                           is_pinned=lambda: where == "pinned")


@pytest.mark.parametrize("src,dst,counter", [
    ("host", "cuda", "h2d_pageable_bytes"),
    ("cuda", "host", "d2h_pageable_bytes"),
    ("pinned", "cuda", None),
    ("cuda", "pinned", None),
    ("host", "host", None),
    ("cuda", "cuda", None),
])
def test_copy_counting_rule(src, dst, counter):
    root = f"copy-rule-{src}-{dst}"
    s, d = _tensor(src, 12345), _tensor(dst, 12345)
    with profiling.span(root):
        assert profiling.copied(s, d) is d
    c = profiling.counters()[root]
    assert {k: c.get(k, 0) for k in PAGEABLE} == {k: 12345 if k == counter else 0
                                                   for k in PAGEABLE}


def test_copies_of_real_host_tensors_count_nothing():
    root = "copy-rule-torch"
    x = torch.arange(1000, dtype=torch.int32)
    with profiling.span(root):
        assert profiling.copied(x, x.to(CPU)) is x
        assert profiling.copied(x, x.cpu()) is x
    assert all(profiling.counters()[root].get(k, 0) == 0 for k in PAGEABLE)


def test_count_without_an_open_root_goes_nowhere():
    before = profiling.counters()
    profiling.count("bytes_in", 99)
    assert profiling.counters() == before


def test_a_span_that_raises_still_closes():
    before = profiling.counters().get("decompress", {}).get("calls", 0)
    version_3 = int(bf.NATIVE_MAGIC).to_bytes(4, "little") + bytes([3]) + bytes(40)
    with pytest.raises(ValueError, match="unsupported container version"):
        bf.decompress(version_3, CPU)
    assert profiling.counters()["decompress"]["calls"] == before + 1
    with profiling.span("after-raise"):
        profiling.count("n", 1)
    # Opened on an empty stack: a root of its own, not a stage of the call
    # that raised.
    c = profiling.counters()["after-raise"]
    memory = profiling._memory_counter()
    assert set(c) == {"n", memory, "calls"} and c["n"] == c["calls"] == 1 and c[memory] >= 0


@pytest.mark.parametrize("name", [profiling.FAULTS, profiling.RESIDENT])
def test_faults_counted_per_stage_and_root(monkeypatch, name):
    # The kernel's count of the thread's faults, or, as on a kernel that
    # counts none, the growth of the process's resident set in pages.
    monkeypatch.setattr(profiling, "_memory", name)
    root = f"faults-root-{name}"
    # A fresh anonymous mapping: the heap could serve a buffer from pages
    # that are resident already.
    with mmap.mmap(-1, 32 << 20) as fresh:
        pages = np.frombuffer(fresh, dtype=np.uint8)
        with profiling.span(root):
            with profiling.span("touch"):
                pages[::4096] = 1  # each page touched once
            with profiling.span("idle"):
                pass
        del pages
    c = profiling.counters()[root]
    other = ({profiling.FAULTS, profiling.RESIDENT} - {name}).pop()
    assert not any(k.startswith(other) for k in c)
    assert c[f"{name}.touch"] > 0 and c[name] >= c[f"{name}.touch"]
    assert c.get(f"{name}.idle", 0) <= c[f"{name}.touch"] // 8
    if name == profiling.RESIDENT:
        assert c[f"{name}.touch"] >= (32 << 20) // 4096 * 0.9


def test_threads_keep_their_own_stacks_and_no_update_is_lost():
    n_threads, n_spans = 16, 400
    errors: list[BaseException] = []

    def work(i: int):
        try:
            for _ in range(n_spans):
                with profiling.span(f"thread-root-{i % 2}"):
                    with profiling.span("stage"):
                        profiling.count("n", 1)
        except BaseException as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    c = profiling.counters()
    for r in range(2):
        root = c[f"thread-root-{r}"]
        assert root["calls"] == root["n"] == n_threads // 2 * n_spans
        assert root[profiling._memory_counter()] >= 0


def test_resident_growth_under_threads_is_counted_once(monkeypatch):
    # Each thread touches fresh pages inside its spans; the resident set is
    # the process's, so no page of its growth may go to more than one span.
    monkeypatch.setattr(profiling, "_memory", profiling.RESIDENT)
    n_threads, size = 8, 4 << 20
    maps = [mmap.mmap(-1, size) for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def work(i: int):
        pages = np.frombuffer(maps[i], dtype=np.uint8)
        start.wait()
        with profiling.span(f"resident-threads-{i}"):
            for j in range(0, size, 1 << 16):
                with profiling.span("touch"):
                    pages[j:j + (1 << 16):4096] = 1
        del pages

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        for m in maps:
            m.close()
    assert not any(t.is_alive() for t in threads)
    c = profiling.counters()
    counted = sum(c[f"resident-threads-{i}"].get(profiling.RESIDENT, 0) for i in range(n_threads))
    touched = n_threads * size // 4096
    assert 0 < counted <= touched * 1.25 + 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_copy_rule_on_the_card(dev):
    root = "copy-rule-card"
    x = torch.arange(1 << 16, dtype=torch.int32)
    with profiling.span(root):
        on_card = profiling.copied(x, x.to(dev))
        profiling.copied(x.pin_memory(), x.pin_memory().to(dev))
        back = profiling.copied(on_card, on_card.cpu())
        pinned = torch.empty_like(x).pin_memory()
        profiling.copied(on_card, pinned.copy_(on_card))
    assert torch.equal(back, x)
    c = profiling.counters()[root]
    assert (c["h2d_pageable_bytes"], c["d2h_pageable_bytes"]) == (x.nbytes, x.nbytes)


@pytest.mark.cuda
def test_pageable_bytes_of_a_decompress_on_the_card(dev):
    from huffman_tpu_torch.constants import GROUP_LANES, MAX_CODE_LEN, MAX_SYMBOLS
    from huffman_tpu_torch.container import interleave as il

    data = _data(3 << 20)
    blob = ht.compress(data, device=dev)
    c = bf.ParsedContainer(blob)
    streams = il.pad_streams(list(c.streams))[0]
    tables = 4 * MAX_CODE_LEN + 4 * (MAX_CODE_LEN + 1) + 2 * c.n_unique + 3 * 4 * MAX_SYMBOLS
    before = profiling.counters()
    assert ht.decompress(blob, device=dev) == data
    got = _delta(before, profiling.counters(), "decompress")
    # The streams go up from the thread's pinned buffer: only n_real and
    # the tables cross from pageable memory.
    assert got["h2d_pageable_bytes"] == 4 * c.ngroups + tables
    assert sum(got.get(k, 0) for k in UPLOAD_BUFFER) == 1
    assert streams.nbytes == 4 * c.ngroups * c.row_words
    # The decoded symbols come down into the thread's pinned download
    # buffer: nothing crosses into pageable memory.
    assert sum(got.get(k, 0) for k in DOWNLOAD_BUFFER) == 1
    assert bf._host_buffers.by_key[("download", True)].is_pinned()
    assert bf._host_buffers.by_key[("download", True)].numel() >= \
        c.ngroups * GROUP_LANES * c.block_symbols * 2
    assert got.get("d2h_pageable_bytes", 0) == 0
    # The CRC32 was taken on the card, and its 4 bytes came down pinned too.
    assert (got.get("crc_device", 0), got.get("crc_host", 0)) == (1, 0)
