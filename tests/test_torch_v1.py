"""The port's per-block slab path against the JAX package: the lane-pack
slab (``pack_blocks``) against ``pack_blocks_pallas`` in interpret mode,
the tensor-op twins of ``ops/encode.py``, ``ops/decode.py`` and
``ops/device_interleave.py`` against the JAX functions, and v1 containers
(and containers without an embedded codebook) against
``huffman_tpu.compress(backend="numpy")``, each package decoding the
other's. Exact equality throughout, garbage decode steps included."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import GROUP_LANES, MAX_SYMBOLS
from huffman_tpu.ops import decode as jdec
from huffman_tpu.ops import encode as jenc
from huffman_tpu.ops.device_interleave import build_streams_device as jax_build_streams_device
from huffman_tpu.ops.pallas_encode import pack_blocks_pallas
from huffman_tpu.ops.tables import device_tables
from huffman_tpu.utils.benchmark import silesia_like, zipf_pairs
from huffman_tpu_torch.ops import cuda_encode, decode, device_interleave, encode
from huffman_tpu_torch.ops.tables import tables_from_codebook

CPU = torch.device("cpu")


def _coded(seed, n_lanes, B, n_pairs, n_unique, max_len):
    """Codes and lengths of a Zipf draw laid out (n_lanes, B), zero past
    ``n_pairs``, with its codebook and symbols."""
    rng = np.random.default_rng(seed)
    alpha = rng.choice(MAX_SYMBOLS, n_unique, replace=False)
    p = 1.0 / np.arange(1, n_unique + 1) ** 1.1
    sym = np.zeros(n_lanes * B, np.uint16)
    sym[:n_pairs] = rng.choice(alpha, n_pairs, p=p / p.sum())
    cb = Codebook.from_lengths(
        package_merge_lengths(np.bincount(sym[:n_pairs], minlength=MAX_SYMBOLS), max_len)
    )
    valid = np.arange(sym.size) < n_pairs
    codes = np.where(valid, cb.codes[sym], 0).astype(np.uint32).reshape(n_lanes, B)
    lens = np.where(valid, cb.lengths[sym], 0).astype(np.int32).reshape(n_lanes, B)
    return codes, lens, cb, sym.reshape(n_lanes, B)


def _t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


@pytest.mark.parametrize("seed,B,max_len,W", [(0, 16, 12, 8), (1, 32, 26, 32), (2, 8, 18, 2)])
def test_pack_blocks_matches_pallas(seed, B, max_len, W):
    """W = 2 is too narrow for some blocks: both clamp into the row."""
    codes, lens, _, _ = _coded(seed, GROUP_LANES, B, GROUP_LANES * B - 5, 500, max_len)
    want = np.asarray(pack_blocks_pallas(jnp.asarray(codes), jnp.asarray(lens), W, interpret=True))
    got = cuda_encode.pack_blocks(_t(codes), _t(lens), W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed,B,max_len,W", [(3, 16, 18, 12), (4, 24, 32, 4)])
def test_encode_ops_match_jax(seed, B, max_len, W):
    """gather_codes (two tables), block_offsets and pack_blocks; W = 4
    lets blocks run into the next row and the last one past the slab."""
    n_lanes = 50
    codes, lens, cb, sym = _coded(seed, n_lanes, B, n_lanes * B - 9, 200, max_len)
    n_valid = n_lanes * B - 9
    t = tables_from_codebook(cb, CPU)
    jt = device_tables(cb)
    got_c, got_l = encode.gather_codes(torch.from_numpy(sym.view(np.int16)), t.enc_codes, t.enc_lens, n_valid)
    valid = jnp.asarray(np.arange(sym.size).reshape(sym.shape) < n_valid)
    want_c, want_l = jenc.gather_codes(jnp.asarray(sym.astype(np.int32)), jt.enc_codes, jt.enc_lens, valid)
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32), np.asarray(want_c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    off, bits = encode.block_offsets(got_l)
    want_off, want_bits = jenc.block_offsets(want_l)
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    got = encode.pack_blocks(got_c, got_l, off, W)
    want = jenc.pack_blocks(want_c, want_l, want_off, W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("start_bit,max_len", [(0, 18), (13, 32), (29, 26)])
def test_pack_stream_matches_jax(start_bit, max_len):
    """One continuous stream from (word, bit) offset pairs, starting at a
    header's odd bit position."""
    codes, lens, _, _ = _coded(7, 1, 3000, 2990, 300, max_len)
    lens64 = lens.reshape(-1).astype(np.int64)
    off = np.cumsum(lens64) - lens64 + start_bit
    ow, ob = (off >> 5).astype(np.int32), (off & 31).astype(np.int32)
    total = int((off[-1] + lens64[-1] + 31) >> 5)
    want = jenc.pack_stream(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(ow), jnp.asarray(ob), total)
    got = encode.pack_stream(_t(codes), _t(lens), torch.from_numpy(ow), torch.from_numpy(ob), total)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("n_real,W", [(1500, 40), (2048, 3)])
def test_build_streams_device_matches_jax(n_real, W):
    """W = 3 drops the words past each lane's slab row, as the JAX function
    does; the caps bound every group."""
    B = 16
    n_lanes = 2 * GROUP_LANES
    n_pairs = n_real * B - 3
    codes, lens, cb, _ = _coded(9, n_lanes, B, n_pairs, 300, 18)
    off, _ = jenc.block_offsets(jnp.asarray(lens))
    slab = np.asarray(jenc.pack_blocks(jnp.asarray(codes), jnp.asarray(lens), off, W))
    min_len = int(cb.lengths[cb.lengths > 0].min())
    eff = np.where(np.arange(n_lanes * B).reshape(n_lanes, B) < n_pairs, lens, min_len).astype(np.int32)
    cap = B * GROUP_LANES
    want_s, want_c = jax_build_streams_device(
        jnp.asarray(slab), jnp.asarray(eff), jnp.int32(n_real), words_cap=cap
    )
    got_s, got_c = device_interleave.build_streams_device(_t(slab), _t(eff), n_real, cap)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("n_unique,max_len", [(1, 12), (300, 12), (5000, 32)])
def test_decode_blocks_matches_jax(n_unique, max_len):
    """Whole outputs, the garbage steps past each block's data included,
    with the JAX package's padded symbol table on both sides."""
    B, n_lanes = 32, 40
    codes, lens, cb, sym = _coded(n_unique, n_lanes, B, n_lanes * B - 11, n_unique, max_len)
    off, _ = jenc.block_offsets(jnp.asarray(lens))
    W = 10
    slab = np.asarray(jenc.pack_blocks(jnp.asarray(codes), jnp.asarray(lens), off, W))
    jt = device_tables(cb)
    want = np.asarray(jdec.decode_blocks(jnp.asarray(slab), jt.lj_limit, jt.base, jt.sym_order, B, jt.max_len))
    t = tables_from_codebook(cb, CPU)
    got = decode.decode_blocks(_t(slab), t.lj_limit, t.base, torch.from_numpy(np.asarray(jt.sym_order)), B, t.max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    real = np.arange(sym.size).reshape(sym.shape) < n_lanes * B - 11
    np.testing.assert_array_equal(got.numpy()[real], sym[real])


def _inputs():
    return {
        "silesia_like": silesia_like(150_000, seed=7).tobytes(),
        "zipf30k_odd": zipf_pairs(120_001, 30000, np.random.default_rng(3)).tobytes(),
        "empty": b"",
        "one_byte": b"\x7f",
        "single_symbol": b"ab" * 5000,
        "random_bytes": np.random.default_rng(0).integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_v1_containers_match_jax_and_cross_decode(name):
    data = _inputs()[name]
    ours = huffman_tpu_torch.compress(data, "cpu", block_symbols=64, mode="blocks")
    theirs = huffman_tpu.compress(data, backend="numpy", block_symbols=64, mode="blocks")
    assert ours == theirs
    assert huffman_tpu_torch.decompress(theirs, "cpu") == data
    if len(data) < 50_000:  # the JAX package decodes v1 with a host loop per symbol
        assert huffman_tpu.decompress(ours) == data


@pytest.mark.parametrize("mode", ["interleaved", "blocks"])
def test_external_codebook_and_unchecked_crc(mode):
    data = zipf_pairs(40_000, 300, np.random.default_rng(8)).tobytes()
    jcb = Codebook.from_frequencies(np.bincount(np.frombuffer(data, "<u2"), minlength=MAX_SYMBOLS))
    cb = huffman_tpu_torch.Codebook.from_lengths(np.asarray(jcb.lengths))
    ours = huffman_tpu_torch.compress(data, "cpu", block_symbols=64, codebook=cb,
                                      mode=mode, embed_codebook=False)
    assert ours == huffman_tpu.compress(data, backend="numpy", block_symbols=64, codebook=jcb,
                                        mode=mode, embed_codebook=False)
    assert huffman_tpu_torch.decompress(ours, "cpu", codebook=cb) == data
    assert huffman_tpu.decompress(ours, codebook=jcb) == data
    with pytest.raises(ValueError, match="codebook="):
        huffman_tpu_torch.decompress(ours, "cpu")
    with pytest.raises(ValueError, match="explicit codebook"):
        huffman_tpu_torch.compress(data, "cpu", embed_codebook=False)

    blob = bytearray(ours)
    blob[28] ^= 1  # the stored CRC32, not the payload
    with pytest.raises(ValueError, match="CRC"):
        huffman_tpu_torch.decompress(bytes(blob), "cpu", codebook=cb)
    assert huffman_tpu_torch.decompress(bytes(blob), "cpu", codebook=cb, verify_crc=False) == data
