"""The port's in-kernel stream deposit (K10 plain version) against the JAX
package's ``deposit_streams_pallas`` in interpret mode, and the port's
``pack_streams_kernel_deposit`` against the JAX function of that name, the
tensor-op ``pack_streams`` and the host protocol
``build_interleaved_streams``. The cases are those of
tests/test_pallas_encode.py, at an exact and a loose cap. Exact equality."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from huffman_tpu.bitio import pack_codes_blocked
from huffman_tpu.constants import GROUP_LANES, PRELOAD_WORDS
from huffman_tpu.container import interleave as il
from huffman_tpu.ops import pallas_encode as pe
from huffman_tpu_torch.ops import cuda_encode as ce

CASES = [  # seed, n_real, B, min_len, max_len, n_groups
    (0, 1000, 32, 1, 18, 1),    # mixed lengths, pad lanes
    (1, 1024, 32, 1, 1, 1),     # all-ones: minimum fire density
    (2, 1024, 16, 32, 32, 1),   # all-32: every step fires, cap tight
    (3, 2400, 16, 1, 32, 3),    # multiple groups, full length range
    (4, 700, 16, 1, 2, 1),      # tiny totals: lanes with < 64 bits
    (5, 1, 32, 5, 12, 1),       # a single real lane
]


def _case(seed, n_real, B, min_len, max_len, n_groups):
    """(codes, eff, slab): random codes on the real steps, code 0 with
    ``min_len`` on the garbage steps, and the lanes' packed words."""
    rng = np.random.default_rng(seed)
    n_lanes = n_groups * GROUP_LANES
    n_pairs = n_real * B - rng.integers(0, B)
    lens = rng.integers(min_len, max_len + 1, size=(n_lanes, B)).astype(np.int32)
    codes = (rng.integers(0, 1 << 30, size=(n_lanes, B)).astype(np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    valid = (np.arange(n_lanes * B) < n_pairs).reshape(n_lanes, B)
    codes = np.where(valid, codes, 0).astype(np.uint32)
    eff = np.where(valid, lens, min_len).astype(np.int32)
    real = np.where(valid, lens, 0)
    slab, _ = pack_codes_blocked(codes, real, max(int(real.sum(axis=1).max() + 31) // 32, 1))
    return codes, eff, slab


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _caps(ref, B):
    body_max = max(s.size - PRELOAD_WORDS * GROUP_LANES for s in ref)
    return sorted({max(body_max, 1), B * GROUP_LANES})


@pytest.mark.parametrize("case", CASES, ids=[str(c[0]) for c in CASES])
def test_deposit_plain_matches_pallas(case):
    codes, eff, slab = _case(*case)
    n_real, B = case[1], case[2]
    ref = il.build_interleaved_streams(slab, eff, n_real)
    staging = ce.pack_lanes(_t(codes), _t(eff))
    r, fire = ce._fires(_t(eff), n_real)
    mb = -(-B // 32)
    fire_p = np.pad(fire.numpy(), ((0, 0), (0, mb * 32 - B))).reshape(-1, mb, 32)
    mask = (fire_p.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    body = r[:, -1].reshape(-1, GROUP_LANES).sum(dim=1, dtype=torch.int32)
    for cap in _caps(ref, B):
        want = np.asarray(pe.deposit_streams_pallas(
            pe._to_grid(jnp.asarray(staging.numpy())), pe._to_grid(jnp.asarray(mask.view(np.int32))),
            jnp.asarray(body.numpy()), cap, interpret=True,
        ))
        got = ce.deposit_streams(staging, _t(mask), body, cap)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want, err_msg=f"cap={cap}")


@pytest.mark.parametrize("case", CASES, ids=[str(c[0]) for c in CASES])
def test_kernel_deposit_matches_jax_and_protocol(case):
    codes, eff, slab = _case(*case)
    n_real, B = case[1], case[2]
    ref = il.build_interleaved_streams(slab, eff, n_real)
    for cap in _caps(ref, B):
        want_s, want_c = pe.pack_streams_kernel_deposit(
            jnp.asarray(codes), jnp.asarray(eff), jnp.int32(n_real), words_cap=cap, interpret=True,
        )
        streams, counts = ce.pack_streams_kernel_deposit(_t(codes), _t(eff), n_real, cap)
        np.testing.assert_array_equal(streams.numpy().view(np.uint32), np.asarray(want_s))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
        tensor_s, tensor_c = ce.pack_streams(_t(codes), _t(eff), n_real, cap)
        np.testing.assert_array_equal(counts.numpy(), tensor_c.numpy())
        for g, s in enumerate(ref):
            got = streams.numpy().view(np.uint32)[g]
            assert counts[g] == s.size
            np.testing.assert_array_equal(got[: s.size], s)
            np.testing.assert_array_equal(got[: s.size], tensor_s.numpy().view(np.uint32)[g, : s.size])
            assert not got[s.size :].any()


def test_deposit_rejects_a_small_cap():
    codes, eff, _ = _case(*CASES[0])
    with pytest.raises(ValueError, match="words_cap"):
        ce.pack_streams_kernel_deposit(_t(codes), _t(eff), CASES[0][1], 16)
