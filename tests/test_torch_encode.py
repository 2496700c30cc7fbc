"""Port lane pack (K4 plain version) and stream assembly against the JAX
Pallas packer run in interpret mode and the host interleave protocol.
Exact equality."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from huffman_tpu.codebook import Codebook, package_merge_lengths
from huffman_tpu.constants import GROUP_LANES, MAX_SYMBOLS
from huffman_tpu.container import interleave as il
from huffman_tpu.ops import pallas_encode as pe
from huffman_tpu_torch.ops.cuda_encode import pack_lanes, pack_lanes_plain, pack_streams
from huffman_tpu_torch.u32 import narrow, shl, widen

N_LANES = 2 * GROUP_LANES


def _inputs(seed, B, n_real, alphabet_size, max_len):
    """(codes, eff) as the container encoder feeds the packer: real codes
    on the first n_pairs positions, code 0 / min_len after them."""
    rng = np.random.default_rng(seed)
    n_pairs = n_real * B - int(rng.integers(1, B))
    alphabet = rng.choice(MAX_SYMBOLS, size=alphabet_size, replace=False)
    p = 1.0 / np.arange(1, alphabet_size + 1) ** 1.1
    symbols = rng.choice(alphabet, size=n_pairs, p=p / p.sum()).astype(np.uint16)
    cb = Codebook.from_lengths(
        package_merge_lengths(np.bincount(symbols, minlength=MAX_SYMBOLS), max_len)
    )
    padded = np.zeros(N_LANES * B, np.uint16)
    padded[:n_pairs] = symbols
    codes = np.where(np.arange(padded.size) < n_pairs, cb.codes[padded], 0)
    lens = np.where(np.arange(padded.size) < n_pairs, cb.lengths[padded], 0)
    min_len = int(cb.lengths[cb.lengths > 0].min())
    eff = il.effective_lengths(lens.reshape(N_LANES, B), n_pairs, min_len, N_LANES, B)
    return codes.astype(np.uint32).reshape(N_LANES, B), eff.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("seed,B,max_len", [(0, 16, 12), (1, 64, 18), (2, 10, 26)])
def test_pack_lanes_matches_pallas_staging(seed, B, max_len):
    codes, eff = _inputs(seed, B, 1500, 2000, max_len)
    want = np.asarray(pe._staging(jnp.asarray(codes), jnp.asarray(eff), interpret=True))
    got = pack_lanes(_t(codes), _t(eff))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_lanes_handles_32_bit_codes():
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 33, size=(GROUP_LANES, 24)).astype(np.int32)
    codes = (rng.integers(0, 1 << 32, size=lens.shape, dtype=np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    want = np.asarray(pe._staging(jnp.asarray(codes), jnp.asarray(lens), interpret=True))
    np.testing.assert_array_equal(pack_lanes(_t(codes), _t(lens)).numpy().view(np.uint32), want)


def _pack_prefix_sum(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """K4's arithmetic (csrc/pack.cu) as tensor ops: each code starts at
    the exclusive cumsum of the lengths; its one or two parts (the serial
    walk's shifts) add into the lane's words, disjoint bits under the
    precondition code < 2**L; a step that fills its start word emits that
    word; the final partial word is the word at the lane's bit total."""
    c, L = widen(codes), lens.to(torch.int64)
    n_lanes, B = c.shape
    start = torch.cumsum(L, dim=1) - L
    k, tot = start >> 5, (start & 31) + L
    first = torch.where(tot <= 32, shl(c, (32 - tot) & 31), c >> ((tot - 32) & 31))
    first = torch.where(L == 0, 0, first)
    spill = torch.where(tot > 32, shl(c, (64 - tot) & 31), 0)
    words = torch.zeros((n_lanes, B + 2), dtype=torch.int64)
    words.scatter_add_(1, k, first)
    words.scatter_add_(1, k + 1, spill)
    staging = torch.empty((n_lanes, B + 1), dtype=torch.int64)
    staging[:, :B] = torch.where(tot >= 32, words.gather(1, k), 0)
    total = start[:, -1:] + L[:, -1:]
    staging[:, B:] = torch.where((total & 31) > 0, words.gather(1, total >> 5), 0)
    return narrow(staging)


def _pack_case(kind, B, seed):
    """(codes, lens) for GROUP_LANES lanes: random lengths 0..32 with
    codes below 2**L, then a run of 32-bit codes, a run of L = 0, or every
    other lane ending exactly on a word boundary."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 33, size=(GROUP_LANES, B)).astype(np.int64)
    run = slice(B // 4, max(3 * B // 4, B // 4 + 1))
    if kind == "runs32":
        lens[:, run] = 32
    elif kind == "runs0":
        lens[:, run] = 0
    elif kind == "boundary":
        head = lens[::2, :-1].sum(axis=1)
        lens[::2, -1] = (-head) % 32
    codes = (rng.integers(0, 1 << 32, size=lens.shape, dtype=np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    return codes, lens.astype(np.int32)


@pytest.mark.parametrize("kind,B", [("mixed", 1), ("mixed", 2), ("mixed", 30), ("mixed", 64),
                                    ("mixed", 513), ("runs32", 64), ("runs0", 64),
                                    ("boundary", 30), ("boundary", 513)])
def test_pack_prefix_sum_form_matches_plain_and_pallas(kind, B):
    """The prefix-sum form the K4 kernel computes equals the serial walk of
    pack_lanes_plain and the Pallas _staging, bit for bit."""
    codes, lens = _pack_case(kind, B, B)
    if kind == "boundary":
        assert not (lens[::2].sum(axis=1) % 32).any()
    got = _pack_prefix_sum(_t(codes), _t(lens))
    np.testing.assert_array_equal(got.numpy(), pack_lanes_plain(_t(codes), _t(lens)).numpy())
    want = np.asarray(pe._staging(jnp.asarray(codes), jnp.asarray(lens), interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed,B,n_real", [(3, 16, 1500), (4, 32, 2048), (5, 8, 1)])
def test_pack_streams_matches_pallas_and_protocol(seed, B, n_real):
    codes, eff = _inputs(seed, B, n_real, 300, 18)
    eff_real = np.where((np.arange(N_LANES) < n_real)[:, None], eff, 0)
    gwords = (eff_real.sum(axis=1) >> 5).reshape(-1, GROUP_LANES).sum(axis=1)
    cap = int(gwords.max()) + 5
    want_s, want_c = pe.pack_streams_pallas(
        jnp.asarray(codes), jnp.asarray(eff), jnp.asarray(n_real, jnp.int32),
        words_cap=cap, interpret=True,
    )
    streams, counts = pack_streams(_t(codes), _t(eff), n_real, cap)
    np.testing.assert_array_equal(streams.numpy().view(np.uint32), np.asarray(want_s))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))

    # The same streams as the host simulation of the decoder.
    slab = np.zeros((N_LANES, B + 1), np.uint32)
    st = pack_lanes(_t(codes), _t(eff)).numpy().view(np.uint32)
    for lane in range(n_real):
        w = st[lane, :B][np.diff(np.cumsum(eff[lane]) >> 5, prepend=0) > 0]
        slab[lane, : w.size] = w
        slab[lane, w.size] = st[lane, B]
    host = il.build_interleaved_streams(slab, eff, n_real)
    for g, s in enumerate(host):
        np.testing.assert_array_equal(streams.numpy().view(np.uint32)[g, : counts[g]], s)


def test_pack_streams_rejects_a_small_cap():
    codes, eff = _inputs(6, 16, 1500, 300, 18)
    with pytest.raises(ValueError, match="words_cap"):
        pack_streams(_t(codes), _t(eff), 1500, 16)
