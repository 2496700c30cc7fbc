"""``ResidentContainer`` on the CPU: a container held on a device and
decoded there by ``decompress(handle)`` into a uint8 tensor, against the
benchmark's plain reference (``codec_bench/reference/htpu.py``) and against
``decompress(bytes)``. The handle runs K1's plain version and zlib here;
``tests/test_torch_cuda.py`` holds it on the card."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import huffman_tpu_torch as ht
from codec_bench.reference import htpu
from codec_bench.tests.test_cb_reference import CASES
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.utils import profiling

CPU = "cpu"
RESIDENT_CASES = {
    **CASES,
    "stored": lambda: np.random.default_rng(12).integers(0, 256, 70001, dtype=np.uint8).tobytes(),
}


def _bytes(t: torch.Tensor) -> bytes:
    return t.numpy().tobytes()


def _flipped(blob: bytes) -> bytes:
    """``blob`` with one bit flipped in the middle of its payload."""
    out = bytearray(blob)
    out[len(out) // 2] ^= 0x10
    return bytes(out)


def _delta(before: dict, after: dict, root: str) -> dict:
    a, b = before.get(root, {}), after.get(root, {})
    return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}


@pytest.mark.parametrize("case", list(RESIDENT_CASES))
def test_resident_decode_equals_the_reference(case):
    data = RESIDENT_CASES[case]()
    blob = ht.compress(data, device=CPU)
    h = ht.ResidentContainer(blob, device=CPU)
    out = ht.decompress(h)
    assert out.dtype == torch.uint8 and out.device.type == "cpu" and out.shape == (len(data),)
    assert _bytes(out) == htpu.decode(blob) == ht.decompress(blob, device=CPU) == data
    assert (h.raw is not None) == (case in ("stored", "one_pair_block", "one_byte", "empty",
                                            "full_alphabet_odd"))
    assert _bytes(ht.decompress(h)) == data  # the handle decodes again


def test_held_v2_rows_and_tables():
    data = CASES["zipf300_partial_group"]()
    blob = ht.compress(data, device=CPU)
    h = ht.ResidentContainer(blob, device=CPU)
    c = bf.ParsedContainer(blob)
    assert h.raw is None and h.ngroups == c.ngroups == 2
    assert np.array_equal(h.streams.numpy().view(np.uint32), c.padded_streams())
    assert h.n_real.tolist() == c.n_real.tolist()
    assert h.tables.enc_codes is None and h.tables.enc_lens is None  # K1 reads none of them
    assert h.nbytes == sum(t.nbytes for t in (h.streams, h.n_real, h.tables.lj_limit,
                                              h.tables.base, h.tables.sym_order))


def test_flipped_bit_raises_the_text_of_decompress_bytes():
    blob = _flipped(ht.compress(CASES["silesia_odd"](), device=CPU))
    with pytest.raises(ValueError) as from_bytes:
        ht.decompress(blob, device=CPU)
    h = ht.ResidentContainer(blob, device=CPU)
    with pytest.raises(ValueError) as resident:
        ht.decompress(h)
    assert str(resident.value) == str(from_bytes.value) == \
        "CRC mismatch: corrupt container or decode bug"


def test_verify_crc_false_skips_the_check():
    blob = _flipped(ht.compress(CASES["silesia_odd"](), device=CPU))
    h = ht.ResidentContainer(blob, device=CPU)
    before = profiling.counters()
    out = ht.decompress(h, verify_crc=False)
    assert _bytes(out) == ht.decompress(blob, device=CPU, verify_crc=False)
    got = _delta(before, profiling.counters(), "decompress")
    assert "crc_host" not in got and "crc_device" not in got and got["resident_calls"] == 1


def test_external_codebook_taken_at_load():
    """A container that stores no codebook is refused at load and sent to
    ``decompress(bytes)``, which takes the codebook."""
    data = CASES["silesia_even"]()
    cb = ht.Codebook.from_frequencies(
        np.bincount(np.frombuffer(data, "<u2"), minlength=65536).astype(np.int64))
    blob = ht.compress(data, device=CPU, codebook=cb, embed_codebook=False)
    with pytest.raises(ValueError, match=r"^container stores its codebook externally; "
                                         r"pass codebook= to decompress\(bytes\)$"):
        ht.ResidentContainer(blob, device=CPU)
    assert ht.decompress(blob, device=CPU, codebook=cb) == data


@pytest.mark.parametrize("kind", ["v1", "htps", "htpx"])
def test_other_containers_name_decompress_bytes(kind):
    data = CASES["silesia_odd"]()
    if kind == "v1":
        blob = ht.compress(data, device=CPU, mode="blocks")
    elif kind == "htpx":
        blob = ht.compress(data, device=CPU, n_shards=2)
    else:
        from huffman_tpu_torch.container import streaming

        blob = streaming.compress_bytes(data, device=CPU, chunk_bytes=1 << 17)
    with pytest.raises(ValueError, match=r"decompress\(bytes\)"):
        ht.ResidentContainer(blob, device=CPU)
    assert ht.decompress(blob, device=CPU) == data


def test_not_a_container_raises():
    with pytest.raises(ValueError, match="not an HTPU container"):
        ht.ResidentContainer(b"\x00" * 64, device=CPU)


def test_load_and_decode_counters_and_no_thread_buffer():
    """The load root counts the held and the original bytes; a decode
    counts ``resident_calls`` and uses neither of the thread's reused host
    buffers, and the load leaves none behind."""
    data = CASES["silesia_odd"]()
    blob = ht.compress(data, device=CPU)
    seen = {}

    def load_and_decode():
        before = profiling.counters()
        h = ht.ResidentContainer(blob, device=CPU)
        mid = profiling.counters()
        for _ in range(3):
            ht.decompress(h)
        seen["load"] = _delta(before, mid, "load")
        seen["decompress"] = _delta(mid, profiling.counters(), "decompress")
        seen["buffers"] = dict(bf._host_buffers.by_key)
        seen["nbytes"] = h.nbytes

    t = threading.Thread(target=load_and_decode)  # a thread with no buffers yet
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert seen["buffers"] == {}
    assert seen["load"]["calls"] == 1
    assert seen["load"]["resident_bytes"] == seen["nbytes"]
    assert seen["load"]["original_bytes"] == len(data)
    d = seen["decompress"]
    assert d["calls"] == d["resident_calls"] == d["crc_host"] == 3
    assert d["bytes_out"] == 3 * len(data) and d["bytes_in"] == 3 * len(blob)
    assert d["host_enqueue_ns"] > 0
    assert not any(k.startswith(("upload_buffer", "download_buffer")) for k in d)


def test_outputs_are_fresh_tensors():
    data = CASES["silesia_odd"]()
    h = ht.ResidentContainer(ht.compress(data, device=CPU), device=CPU)
    first = ht.decompress(h)
    first.zero_()
    assert _bytes(ht.decompress(h)) == data


def _pair():
    a, b = CASES["silesia_odd"](), CASES["deep_codes"]()
    blobs = [ht.compress(x, device=CPU) for x in (a, b)]
    return (a, b), blobs, [ht.ResidentContainer(x, device=CPU) for x in blobs]


def test_two_handles_in_turns_with_bytes_decodes_between():
    (a, b), blobs, handles = _pair()
    other = ht.compress(CASES["zipf300_partial_group"](), device=CPU)
    outs = []
    for _ in range(3):
        for h in handles:
            outs.append(ht.decompress(h))
            assert len(ht.decompress(other, device=CPU)) == len(CASES["zipf300_partial_group"]())
    assert [_bytes(o) for o in outs] == [a, b] * 3


def test_two_handles_from_four_threads():
    (a, b), blobs, handles = _pair()
    errors, done = [], []

    def work(i):
        try:
            for k in range(3):
                h, want = (handles[0], a) if (i + k) % 2 == 0 else (handles[1], b)
                out = ht.decompress(h)
                assert ht.decompress(blobs[(i + k + 1) % 2], device=CPU) == (b if (i + k) % 2 == 0 else a)
                assert _bytes(out) == want
            done.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and sorted(done) == [0, 1, 2, 3]
