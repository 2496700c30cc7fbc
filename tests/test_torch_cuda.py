"""The port's CUDA kernels on a card: each kernel against its plain PyTorch
version on the same CUDA tensors, and the slice against the JAX package's
host path. Exact equality throughout.

These tests need an NVIDIA card (Hopper: the kernels build for sm_90a)
and skip without one. tests/conftest.py imports JAX, which a machine set
up for the port need not have, so run them with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import huffman_tpu
import huffman_tpu_torch
from huffman_tpu.bitio import pack_codes
from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import GROUP_LANES, MAX_SYMBOLS
from huffman_tpu.container import interleave as il
from huffman_tpu.utils.benchmark import silesia_like, zipf_pairs
from huffman_tpu_torch.ops import cuda_decode, cuda_encode, cuda_gather
from huffman_tpu_torch.ops.tables import tables_from_codebook
from huffman_tpu_torch.runtime import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _streams(seed, n_real, B, alphabet_size, max_len):
    rng = np.random.default_rng(seed)
    n_lanes = -(-n_real // GROUP_LANES) * GROUP_LANES
    n_pairs = n_real * B - int(rng.integers(1, B))
    alphabet = rng.choice(MAX_SYMBOLS, size=alphabet_size, replace=False)
    symbols = np.concatenate([alphabet, rng.choice(alphabet, n_pairs - alphabet_size)])
    symbols = symbols.astype(np.uint16)
    cb = Codebook.from_lengths(
        package_merge_lengths(np.bincount(symbols, minlength=MAX_SYMBOLS), max_len)
    )
    lens = cb.lengths[symbols].astype(np.int64)
    rows = [
        pack_codes(cb.codes[symbols[l * B : (l + 1) * B]], lens[l * B : (l + 1) * B])[0]
        for l in range(n_real)
    ]
    slab = np.zeros((n_lanes, max(r.size for r in rows)), np.uint32)
    for i, r in enumerate(rows):
        slab[i, : r.size] = r
    padded = np.zeros(n_lanes * B, np.int64)
    padded[:n_pairs] = lens
    eff = il.effective_lengths(padded.reshape(n_lanes, B), n_pairs,
                               int(cb.lengths[cb.lengths > 0].min()), n_lanes, B)
    streams = il.build_interleaved_streams(slab, eff, n_real)
    return symbols, cb, streams


@pytest.mark.parametrize("alphabet,max_len", [(1, 12), (2, 12), (300, 12), (1024, 18),
                                              (1025, 18), (4000, 12), (30000, 18)])
def test_decode_kernels_match_plain(dev, alphabet, max_len):
    B, n_real = 64, 2500
    symbols, cb, streams = _streams(alphabet, n_real, B, alphabet, max_len)
    stacked, _ = il.pad_streams(streams)
    ngroups = len(streams)
    s = torch.from_numpy(stacked.reshape(ngroups, -1).view(np.int32)).to(dev)
    n = torch.from_numpy(
        np.clip(n_real - GROUP_LANES * np.arange(ngroups), 0, GROUP_LANES).astype(np.int32)
    ).to(dev)
    t = tables_from_codebook(cb, dev)
    translate = cb.n_unique <= cuda_decode.TRANSLATE_MAX_ALPHABET
    got = cuda_decode.decode_groups(s, n, t, B, translate)
    want = cuda_decode.decode_groups_plain(s, n, t, B, translate)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if not translate:
        got = cuda_gather.gather_u16_pairs(got, t.sym_order)
        assert torch.equal(got, cuda_gather.gather_u16_pairs_plain(want, t.sym_order))
    words = got.reshape(ngroups, B // 2, GROUP_LANES).transpose(1, 2).contiguous()
    dec = words.cpu().numpy().view("<u2").reshape(-1)[: symbols.size]
    np.testing.assert_array_equal(dec, symbols)


def test_gather_kernels_match_plain(dev):
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 100_003, dtype=np.int64)
                           .astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, 5000).astype(np.int16)).to(dev)
    assert torch.equal(cuda_gather.gather_u16_pairs(idx, table),
                       cuda_gather.gather_u16_pairs_plain(idx, table))
    sym = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (777, 130)).astype(np.int16)).to(dev)
    enc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 1 << 16).astype(np.int32)).to(dev)
    for n_valid in (0, 12345, sym.numel()):
        got = cuda_gather.gather_codes(sym, enc, n_valid)
        want = cuda_gather.gather_codes_plain(sym, enc, n_valid)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("B", [2, 30, 512])
def test_pack_kernel_matches_plain(dev, B):
    rng = np.random.default_rng(B)
    lens = rng.integers(0, 33, size=(3000, B))
    codes = rng.integers(0, 1 << 32, size=lens.shape, dtype=np.uint64) & (
        (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    )
    c = torch.from_numpy(codes.astype(np.uint32).view(np.int32)).to(dev)
    l = torch.from_numpy(lens.astype(np.int32)).to(dev)
    assert torch.equal(cuda_encode.pack_lanes(c, l), cuda_encode.pack_lanes_plain(c, l))


def _slice_inputs():
    return {
        "silesia_like_4MiB": silesia_like(4 << 20, seed=7).tobytes(),
        "zipf30k_4MiB": zipf_pairs(4 << 20, 30000, np.random.default_rng(3)).tobytes(),
        "zipf300_odd": zipf_pairs(1 << 20, 300, np.random.default_rng(5)).tobytes() + b"\x01",
        "empty": b"",
        "one_byte": b"\xff",
        "single_symbol": b"zz" * 70000,
        "random_bytes": np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("name", sorted(_slice_inputs()))
def test_slice_matches_host_path(dev, name):
    data = _slice_inputs()[name]
    kernels.reset_launch_counts()
    blob = huffman_tpu_torch.compress(data, dev)
    assert blob == huffman_tpu.compress(data, backend="numpy")
    assert huffman_tpu_torch.decompress(blob, dev) == data
    if len(blob) < len(data) and len(data) > 2:
        counts = kernels.launch_counts()
        assert counts["gather_codes"] and counts["pack_lanes"] and counts["decode_groups"]


def test_slice_at_benchmark_size(dev):
    """32 MiB, the size of the repo's benchmark corpora."""
    for data in (silesia_like(32 << 20, seed=7).tobytes(),
                 zipf_pairs(32 << 20, 30000, np.random.default_rng(3)).tobytes()):
        blob = huffman_tpu_torch.compress(data, dev)
        assert blob == huffman_tpu.compress(data, backend="numpy")
        assert huffman_tpu_torch.decompress(blob, dev) == data
