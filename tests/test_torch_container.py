"""The port's HTPU containers against the JAX package: containers equal
byte for byte, and each package decodes the other's containers."""

import sys
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import MAX_SYMBOLS
from huffman_tpu.ops.tables import device_tables
from huffman_tpu.utils.benchmark import silesia_like, zipf_pairs
from huffman_tpu.container import block_format as jax_bf
from huffman_tpu_torch.container import block_format as bf
from huffman_tpu_torch.container import interleave as il
from huffman_tpu_torch.corpus import fibonacci_pairs
from huffman_tpu_torch.ops.tables import tables_from_codebook

CPU = torch.device("cpu")


def _inputs():
    return {
        "silesia_like": silesia_like(150_000, seed=7).tobytes(),
        "zipf4k": zipf_pairs(150_001, 4000, np.random.default_rng(3)).tobytes(),
        "zipf300": zipf_pairs(150_000, 300, np.random.default_rng(4)).tobytes(),
    }


@pytest.mark.parametrize("name", ["silesia_like", "zipf4k", "zipf300"])
def test_compress_equals_jax_device_path_and_cross_decodes(name):
    data = _inputs()[name]
    ours = huffman_tpu_torch.compress(data, device="cpu", block_symbols=64)
    theirs = huffman_tpu.compress(data, backend="jax", block_symbols=64)
    assert ours == theirs
    assert huffman_tpu.decompress(ours) == data
    assert huffman_tpu_torch.decompress(theirs, device="cpu") == data


EDGE = {
    "empty": b"",
    "one_byte": b"\x7f",
    "odd": bytes(range(256)) * 40 + b"!",
    "single_symbol": b"ab" * 5000,
    "random_bytes": np.random.default_rng(0).integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    "two_symbols_odd": b"xyxyyy" * 3001 + b"q",
}


@pytest.mark.parametrize("name", sorted(EDGE))
@pytest.mark.parametrize("max_code_len", [18, None])
def test_edge_inputs_match_host_path(name, max_code_len):
    data = EDGE[name]
    ours = huffman_tpu_torch.compress(data, "cpu", block_symbols=64, max_code_len=max_code_len)
    assert ours == huffman_tpu.compress(
        data, backend="numpy", block_symbols=64, max_code_len=max_code_len
    )
    assert huffman_tpu_torch.decompress(ours, "cpu") == data


def test_caller_codebook_and_odd_block_symbols():
    data = _inputs()["zipf300"][:40_000]
    cb = Codebook.from_frequencies(
        np.bincount(np.frombuffer(data, "<u2"), minlength=MAX_SYMBOLS)
    )
    # The JAX codebook carries over to the port as its lengths.
    port_cb = huffman_tpu_torch.Codebook.from_lengths(np.asarray(cb.lengths))
    ours = huffman_tpu_torch.compress(data, "cpu", block_symbols=33, codebook=port_cb)
    assert ours == huffman_tpu.compress(data, backend="numpy", block_symbols=33, codebook=cb)
    assert huffman_tpu_torch.decompress(ours, "cpu") == data


@pytest.mark.parametrize("kind", ["htpx_global", "htpx_per_shard", "htps"])
def test_jax_htpx_and_htps_blobs_decode(kind):
    """``decompress`` routes the JAX package's sharded archives and
    streams by magic, as ``huffman_tpu.decompress`` does."""
    from huffman_tpu.container import sharded, streaming

    data = _inputs()["zipf300"][:20_001]
    blob = {
        "htpx_global": lambda: huffman_tpu.compress(data, backend="numpy", n_shards=2),
        "htpx_per_shard": lambda: sharded.compress(
            data, n_shards=3, codebook_mode="per-shard", backend="numpy"
        ),
        "htps": lambda: streaming.compress_bytes(data, chunk_bytes=6000, backend="numpy"),
    }[kind]()
    assert huffman_tpu_torch.decompress(blob, "cpu") == data


@pytest.mark.parametrize("mode", ["interleaved", "blocks"])
def test_codes_deeper_than_26_bits(mode):
    """Fibonacci symbol counts: the unlimited code reaches 29 bits, past
    the ``len << 26 | code`` word, so the codes come from the two-table
    gather."""
    data = fibonacci_pairs().tobytes() + b"\x05"
    ours = huffman_tpu_torch.compress(data, "cpu", max_code_len=None, mode=mode)
    theirs = huffman_tpu.compress(data, backend="numpy", max_code_len=None, mode=mode)
    assert ours == theirs
    assert ours[7] == 29  # the header's max code length
    assert huffman_tpu_torch.decompress(theirs, "cpu") == data
    if mode == "interleaved":  # the JAX package decodes v1 with a host loop per symbol
        assert huffman_tpu.decompress(ours) == data


def test_corrupt_payload_fails_crc():
    data = _inputs()["zipf300"][:20_000]
    blob = bytearray(huffman_tpu_torch.compress(data, "cpu", block_symbols=64))
    blob[len(blob) // 2] ^= 0x10  # a payload bit
    with pytest.raises(ValueError, match="CRC"):
        huffman_tpu_torch.decompress(bytes(blob), "cpu")


@pytest.mark.parametrize("n_unique,max_len", [(1, 18), (300, 12), (30000, 18)])
def test_tables_match_jax_device_tables(n_unique, max_len):
    rng = np.random.default_rng(n_unique)
    freqs = np.zeros(MAX_SYMBOLS, np.int64)
    freqs[rng.choice(MAX_SYMBOLS, n_unique, replace=False)] = rng.integers(1, 99, n_unique)
    cb = Codebook.from_lengths(package_merge_lengths(freqs, max_len))
    ours = tables_from_codebook(cb, CPU)
    jax_t = device_tables(cb)
    for name in ("lj_limit", "base", "enc_packed"):
        np.testing.assert_array_equal(
            getattr(ours, name).numpy().view(np.uint32), np.asarray(getattr(jax_t, name))
        )
    np.testing.assert_array_equal(
        ours.sym_order.numpy().view(np.uint16), np.asarray(jax_t.sym_order)[:n_unique]
    )
    assert ours.max_len == jax_t.max_len
    assert ours.min_len == int(cb.lengths[cb.lengths > 0].min())


def _long_group_pairs() -> bytes:
    """Five groups of 1024 blocks of 16 pairs: four of a few pairs, the
    fourth of 4,000, so its stream is several times the others'."""
    rng = np.random.default_rng(11)
    groups = [rng.zipf(2.0, 1024 * 16) % 8 for _ in range(5)]
    groups[3] = rng.integers(0, 4000, 1024 * 16)
    return np.concatenate(groups).astype("<u2").tobytes()


def _external_codebook_shard():
    data = _inputs()["zipf300"][:30_000]
    freqs = np.bincount(np.frombuffer(data, "<u2"), minlength=MAX_SYMBOLS)
    cb = huffman_tpu_torch.Codebook.from_lengths(
        huffman_tpu_torch.codebook.package_merge_lengths(freqs, 18)
    )
    blob = huffman_tpu_torch.compress(
        data, "cpu", block_symbols=64, codebook=cb, embed_codebook=False
    )
    return data, blob, cb


def _upload_case(name: str):
    """(data, v2 container, the codebook it leaves out or None)."""
    zipf = (np.random.default_rng(9).zipf(1.3, 40_000) % 3000).astype("<u2").tobytes()
    if name == "external_codebook":
        return _external_codebook_shard()
    data, B = {
        "one_group": (zipf[: 2 * 20_000], 64),                # 313 blocks
        "partial_last_group": (zipf[: 2 * 16 * 1124], 16),    # 1024 + 100 blocks
        "exact_groups": (zipf[: 2 * 16 * 2048], 16),          # two full groups
        "one_long_group": (_long_group_pairs(), 16),
        "odd_length": (zipf[: 2 * 30_000 + 1], 64),
        "single_symbol": (b"ab" * 5000, 64),
    }[name]
    return data, huffman_tpu_torch.compress(data, "cpu", block_symbols=B), None


UPLOAD_CASES = ["one_group", "partial_last_group", "exact_groups", "one_long_group",
                "odd_length", "single_symbol", "external_codebook"]


@pytest.mark.parametrize("name", UPLOAD_CASES)
def test_upload_buffer_matches_pad_streams(name):
    """The one-pass fill of the decoder's padded rows equals
    ``pad_streams`` of the parsed streams byte for byte, whatever the
    buffer held; the lazily built streams equal the JAX parser's."""
    data, blob, cb = _upload_case(name)
    c = bf.ParsedContainer(blob, codebook=cb)
    assert c.version == 2 and not c.stored
    jax_cb = None if cb is None else Codebook.from_lengths(np.asarray(cb.lengths))
    theirs = jax_bf.ParsedContainer(blob, codebook=jax_cb).streams
    assert len(c.streams) == len(theirs) == c.ngroups
    for mine, want in zip(c.streams, theirs):
        assert mine.dtype == want.dtype and np.array_equal(mine, want)
    want = il.pad_streams(c.streams)[0].reshape(c.ngroups, -1)
    assert c.row_words == want.shape[1]
    stale = np.full(want.size + 1000, 0xA5A5A5A5, dtype=np.uint32)
    assert c.padded_streams(stale[: want.size]).tobytes() == want.tobytes()
    assert c.padded_streams().tobytes() == want.tobytes()
    streams, n_real, _, _ = bf.v2_device_inputs(c, CPU)
    assert streams.numpy().view(np.uint32).tobytes() == want.tobytes()
    assert n_real.tolist() == [min(1024, c.num_blocks - 1024 * g) for g in range(c.ngroups)]
    assert huffman_tpu_torch.decompress(blob, "cpu", codebook=cb) == data


def _in_thread(fn):
    """``fn()`` in a new thread (a thread of its own upload buffer)."""
    errors: list[BaseException] = []

    def run():
        try:
            fn()
        except BaseException as e:  # reported by the assertion below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if errors:
        raise errors[0]


def test_upload_buffer_reuse_leaves_no_stale_words():
    """A large container, a smaller one, the large one again, in one
    thread: the smaller one reuses the large one's buffer and carries none
    of its words."""
    cases = {n: _upload_case(n) for n in ("one_long_group", "partial_last_group")}

    def run():
        buffers = []
        for name in ("one_long_group", "partial_last_group", "one_long_group"):
            data, blob, _ = cases[name]
            c = bf.ParsedContainer(blob)
            want = il.pad_streams(c.streams)[0].reshape(c.ngroups, -1)
            streams = bf.v2_device_inputs(c, CPU)[0]
            assert streams.numpy().view(np.uint32).tobytes() == want.tobytes()
            buffers.append(bf._host_buffers.by_key[("upload", False)].data_ptr())
            assert huffman_tpu_torch.decompress(blob, "cpu") == data
        assert len(set(buffers)) == 1  # one buffer, served three times

    _in_thread(run)


def test_download_buffer_reuse_leaves_no_stale_bytes():
    """A large odd-length container (its last byte just past the decoded
    words), a smaller odd-length one (its last byte among the pad
    symbols), the large one again, in one thread: one download buffer
    serves all three, each result equals its input, and none changes when
    the buffer is overwritten afterwards."""
    large = _long_group_pairs() + b"\x09"  # five full groups of 16-pair blocks
    small = _upload_case("odd_length")[0]
    blobs = {x: huffman_tpu_torch.compress(x, "cpu", block_symbols=b)
             for x, b in ((large, 16), (small, 64))}

    def run():
        outputs, buffers = [], []
        for data in (large, small, large):
            outputs.append(huffman_tpu_torch.decompress(blobs[data], "cpu"))
            assert outputs[-1] == data
            buffers.append(bf._host_buffers.by_key[("download", False)])
        assert len({b.data_ptr() for b in buffers}) == 1
        assert buffers[0].numel() == len(large)  # the words and the odd byte past them
        buffers[0].fill_(0xA5)
        assert outputs == [large, small, large]

    _in_thread(run)


def _no_pair_container() -> bytes:
    """A v2 container of one byte that is not stored: compress stores
    every input this short, so the container comes from its route."""
    blob, _ = bf._compress_host_codebook(b"\x07", True, 7, None, 64, 0, 18, CPU,
                                         "interleaved", True)
    return blob


ODD_TAILS = {  # (data, block_symbols, mode): where the odd last byte lands
    "among_pad_symbols": (lambda: _upload_case("odd_length")[0], 64, "interleaved"),
    "past_the_words": (lambda: _upload_case("exact_groups")[0] + b"\xfe", 16, "interleaved"),
    "v1_among_pad_symbols": (lambda: _upload_case("odd_length")[0], 64, "blocks"),
    "v1_past_the_words": (lambda: _upload_case("odd_length")[0][: 2 * 64 * 400] + b"\x01",
                          64, "blocks"),
    "no_pairs": (lambda: b"\x07", 64, "interleaved"),
}


@pytest.mark.parametrize("name", sorted(ODD_TAILS))
def test_odd_tail_in_one_copy_matches_symbols_to_bytes(name):
    """An odd input's output, its last byte written into the decoded
    output before the download and the result copied out of the download
    buffer once, equals ``symbols_to_bytes`` of its pairs and last byte,
    whatever the buffer held before."""
    from huffman_tpu_torch.container.reference_format import symbols_to_bytes

    make, B, mode = ODD_TAILS[name]
    data = make()
    blob = (_no_pair_container() if name == "no_pairs"
            else huffman_tpu_torch.compress(data, "cpu", block_symbols=B, mode=mode))
    c = bf.ParsedContainer(blob)
    assert c.is_odd and not c.stored and c.version == (1 if mode == "blocks" else 2)
    want = symbols_to_bytes(np.frombuffer(data, "<u2", count=len(data) // 2), True, data[-1])
    assert want == data

    def run():
        bf._host_buffer("download", len(data) + 4096, False).fill_(0xA5)
        out = huffman_tpu_torch.decompress(blob, "cpu")
        assert out == want
        bf._host_buffers.by_key[("download", False)].fill_(0x5A)
        assert out == want

    _in_thread(run)


def test_threads_decompress_at_once_each_with_its_own_buffer():
    """Eight threads decompress eight containers of different sizes at
    once, three times each, with a short switch interval."""
    rng = np.random.default_rng(21)
    inputs = [(rng.zipf(1.2, 4000 + 2500 * i) % (300 + 400 * i)).astype("<u2").tobytes()
              for i in range(8)]
    blobs = [huffman_tpu_torch.compress(x, "cpu", block_symbols=16) for x in inputs]
    start = threading.Barrier(len(blobs))
    errors: list[BaseException] = []
    outputs: list[list[bytes]] = [[] for _ in blobs]

    def work(i: int):
        try:
            start.wait()
            for _ in range(3):
                outputs[i].append(huffman_tpu_torch.decompress(blobs[i], "cpu"))
        except BaseException as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(blobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert outputs == [[x] * 3 for x in inputs]


def _group_table_offset(blob: bytes) -> int:
    c = bf.ParsedContainer(blob)
    return len(blob) - 4 * int(c.group_words.sum()) - 4 * c.ngroups


def _corrupt(kind: str) -> bytes:
    blob = bytearray(huffman_tpu_torch.compress(_inputs()["zipf4k"][:70_000], "cpu",
                                                block_symbols=64))
    table = _group_table_offset(bytes(blob))
    if kind == "truncated_group_table":
        return bytes(blob[: table + 2])
    if kind == "group_words_past_payload":
        blob[table : table + 4] = ((len(blob) + 3) // 4 + 1).to_bytes(4, "little")
    elif kind == "truncated_payload":
        return bytes(blob[:-4])
    elif kind == "group_below_its_preloads":  # 2 * 547 preload words in the one group
        blob[table : table + 4] = (2 * 547 - 1).to_bytes(4, "little")
    return bytes(blob)


@pytest.mark.parametrize("kind,text", [
    ("truncated_group_table", "truncated container: group table"),
    ("group_words_past_payload", "corrupt container: group words exceed payload"),
    ("truncated_payload", "truncated container payload"),
    ("group_below_its_preloads", "corrupt container: group words below its preload words"),
])
def test_corrupt_group_tables_raise_at_parse(kind, text):
    """Each raises ``ValueError`` with its text from the parse, as the JAX
    parser raises ``ValueError`` (with the same text but for the short
    group, where NumPy's broadcast fails in its per-group copies)."""
    blob = _corrupt(kind)
    with pytest.raises(ValueError) as mine:
        bf.ParsedContainer(blob)
    assert str(mine.value) == text
    with pytest.raises(ValueError) as theirs:
        jax_bf.ParsedContainer(blob)
    assert kind == "group_below_its_preloads" or str(theirs.value) == text
    with pytest.raises(ValueError, match=text):
        huffman_tpu_torch.decompress(blob, "cpu")
