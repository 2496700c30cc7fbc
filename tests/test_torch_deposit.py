"""The port's in-kernel stream deposit (K10 plain version) against the JAX
package's ``deposit_streams_pallas`` in interpret mode, and the port's
``pack_streams_kernel_deposit`` against the JAX function of that name, the
tensor-op ``pack_streams`` and the host protocol
``build_interleaved_streams``. The cases are those of
tests/test_pallas_encode.py, at an exact and a loose cap. Also
``encode_streams``, the compress routes' stream assembly through K4 +
K10 with its own bucketed cap, against ``pack_streams`` and the JAX
``pack_streams_pallas``, and K10's inputs as ``_deposit_inputs`` builds
them against the per-step word counts of ``_fires``. Exact equality."""

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


ENCODE_CASES = [  # seed, n_groups, B, min_len, max_len, n_pairs
    (0, 1, 32, 1, 18, 1000 * 32 - 7),   # pad lanes, garbage steps in the last real lane
    (1, 3, 16, 1, 29, 2400 * 16 - 3),   # three groups, codes up to 29 bits
    (2, 1, 2, 32, 32, 2048),            # all-32 codes: the body is exactly the bucketed cap
    (3, 3, 8, 3, 12, 2049 * 8 + 5),     # the last group holds two real lanes
    (4, 1, 512, 1, 18, 5),              # one lane, five symbols
]


def _encode_case(seed, n_groups, B, min_len, max_len, n_pairs):
    """(codes, lens, n_real): random codes of random lengths on the first
    ``n_pairs`` positions (row-major), code and length 0 past them."""
    rng = np.random.default_rng(seed)
    n_lanes = n_groups * GROUP_LANES
    lens = rng.integers(min_len, max_len + 1, size=(n_lanes, B)).astype(np.int32)
    codes = (rng.integers(0, 1 << 32, size=(n_lanes, B), dtype=np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    valid = (np.arange(n_lanes * B) < n_pairs).reshape(n_lanes, B)
    return np.where(valid, codes, 0).astype(np.uint32), np.where(valid, lens, 0).astype(np.int32), -(-n_pairs // B)


@pytest.mark.parametrize("case", ENCODE_CASES, ids=[str(c[0]) for c in ENCODE_CASES])
def test_encode_streams_deposit_route_matches_pack_streams_and_pallas(case, monkeypatch):
    """``encode_streams`` (protocol lengths, the bucketed cap, K4 + K10)
    against the tensor-op ``pack_streams`` and the JAX
    ``pack_streams_pallas`` at that cap: the same counts, the same words up
    to each count, zeros after them; K10 runs once, ``pack_streams``
    never."""
    seed, n_groups, B, min_len, max_len, n_pairs = case
    codes, lens, n_real = _encode_case(*case)
    eff = np.where((np.arange(codes.size) < n_pairs).reshape(codes.shape), lens, min_len).astype(np.int32)
    eff_real = np.where((np.arange(codes.shape[0]) < n_real)[:, None], eff, 0)
    body_max = int((eff_real.sum(axis=1) >> 5).reshape(-1, GROUP_LANES).sum(axis=1).max())
    cap = ce.bucket_words(max(body_max, 128))
    if seed == 2:
        assert body_max == cap
    calls = []
    real_deposit, real_pack = ce._deposit, ce.pack_streams
    monkeypatch.setattr(ce, "_deposit", lambda *a: calls.append("K10") or real_deposit(*a))
    monkeypatch.setattr(ce, "pack_streams", lambda *a: calls.append("pack_streams") or real_pack(*a))
    min_len_t = torch.tensor(min_len, dtype=torch.int32)  # as the fused route passes it
    streams, counts = ce.encode_streams(_t(codes), _t(lens), n_pairs, min_len_t, n_real)
    monkeypatch.undo()
    assert calls == ["K10"]
    assert streams.shape == (n_groups, PRELOAD_WORDS * GROUP_LANES + -(-cap // GROUP_LANES) * GROUP_LANES)
    tensor_s, tensor_c = ce.pack_streams(_t(codes), _t(eff), n_real, cap)
    want_s, want_c = pe.pack_streams_pallas(
        jnp.asarray(codes), jnp.asarray(eff), jnp.int32(n_real), words_cap=cap, interpret=True,
    )
    np.testing.assert_array_equal(counts.numpy(), tensor_c.numpy())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    got = streams.numpy().view(np.uint32)
    for g, n in enumerate(counts.tolist()):
        np.testing.assert_array_equal(got[g, :n], tensor_s.numpy().view(np.uint32)[g, :n])
        np.testing.assert_array_equal(got[g, :n], np.asarray(want_s)[g, :n])
        assert not got[g, n:].any()


def test_deposit_streams_checks_a_callers_cap():
    """The public ``deposit_streams`` keeps its check of a caller's
    ``words_cap``: one word below the largest body raises, the body itself
    passes and equals the assembly ``encode_streams`` builds."""
    codes, lens, n_real = _encode_case(*ENCODE_CASES[0])
    n_pairs = ENCODE_CASES[0][5]
    eff = np.where((np.arange(codes.size) < n_pairs).reshape(codes.shape), lens, 1).astype(np.int32)
    st, mask, body = ce._deposit_inputs(_t(codes), _t(eff), n_real)
    with pytest.raises(ValueError, match="words_cap"):
        ce.deposit_streams(st, mask, body, int(body.max()) - 1)
    tight = ce.deposit_streams(st, mask, body, int(body.max()))
    streams, counts = ce.encode_streams(_t(codes), _t(lens), n_pairs, 1, n_real)
    for g, n in enumerate(counts.tolist()):
        assert torch.equal(tight[g, :n], streams[g, :n])


@pytest.mark.parametrize("B", [1, 2, 31, 32, 33, 64, 513])
def test_deposit_inputs_match_the_word_counts(B):
    """K10's inputs as ``_deposit_inputs`` builds them (a step fires when
    its bits carry the running total past a multiple of 32; the fire bits
    packed by a multiply that gathers four bool bytes into a nibble) equal
    those of the per-step word counts of ``_fires`` with an int64
    shift-sum of the fire bits, for lengths 0..32, runs of 32 and of 0, B
    not a multiple of 32, and any number of real lanes."""
    rng = np.random.default_rng(B)
    eff = rng.integers(0, 33, size=(2 * GROUP_LANES, B)).astype(np.int32)
    eff[::3, : B // 2] = 32
    eff[1::3, B // 2 :] = 0
    codes = np.zeros_like(eff)
    for n_real in (0, 1, 1500, 2 * GROUP_LANES):
        staging, mask, body = ce._deposit_inputs(_t(codes), _t(eff), n_real)
        want = _kernel_inputs(codes, eff, n_real, B)
        for got, w in zip((staging, mask, body), want):
            assert torch.equal(got, w), n_real


def _kernel_inputs(codes, eff, n_real, B):
    """(staging, mask_bits, body_words) as ``pack_streams_kernel_deposit``
    hands them to K10."""
    staging = ce.pack_lanes(_t(codes), _t(eff))
    r, fire = ce._fires(_t(eff), n_real)
    mb = -(-B // 32)
    fire_p = np.pad(fire.numpy(), ((0, 0), (0, mb * 32 - B))).reshape(-1, mb, 32)
    mask = (fire_p.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    body = r[:, -1].reshape(-1, GROUP_LANES).sum(dim=1, dtype=torch.int32)
    return staging, _t(mask), body


def _deposit_mirror(staging, mask_bits, body_words, words_cap, max_runs=16):
    """csrc/deposit.cu's decomposition in numpy: block (q, g) takes run q of
    mask words (32 steps each) of group g, at most ``max_runs`` (kMaxRuns)
    runs a group; its slot base is the body count less the group's fires
    after the run, and each lane enters the run with the words of its
    first two fires after it (v1, v2). Word by word from the last,
    per-(step, warp) fire counts give exclusive warp offsets and step
    totals, whose suffix sums give each step's base; each warp then walks
    the word's steps backward, a fired lane storing v2 at base + warp
    offset + its rank in the warp and rolling its carries. Returns (out,
    times each output word was written): the kernel's output starts
    uninitialised, so every word must be written exactly once."""
    st = staging.numpy().view(np.uint32)
    n_lanes, B1 = st.shape
    B = B1 - 1
    mw = mask_bits.shape[1]
    cap = -(-words_cap // GROUP_LANES) * GROUP_LANES
    ngroups = n_lanes // GROUP_LANES
    pre = PRELOAD_WORDS * GROUP_LANES
    bits = (mask_bits.numpy().view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    fire = bits.reshape(n_lanes, mw * 32)[:, :B].astype(bool)
    n_words = -(-B // 32)
    per_run = -(-n_words // max_runs) if n_words > max_runs else 1
    runs = -(-n_words // per_run) if n_words else 1
    out = np.zeros((ngroups, pre + cap), np.uint32)
    written = np.zeros(out.shape, np.int64)

    def store(g, idx, val):
        out[g, idx] = val
        np.add.at(written[g], idx, 1)

    lane = np.arange(GROUP_LANES)
    for g in range(ngroups):
        f_g, st_g = fire[g * GROUP_LANES:(g + 1) * GROUP_LANES], st[g * GROUP_LANES:(g + 1) * GROUP_LANES]
        n_body = int(body_words[g])
        lo = min(max(n_body, 0), cap)
        share = -(-(cap - lo) // runs)
        for q in range(runs):  # the group's blocks share the zeroing past the body
            store(g, pre + np.arange(lo + q * share, min(cap, lo + (q + 1) * share)), 0)
        for q in range(runs):
            w0, w1 = q * per_run, min(n_words, q * per_run + per_run)
            later = f_g[:, 32 * w1:]
            top = n_body - int(later.sum())
            seen = np.cumsum(np.pad(later, ((0, 0), (0, 1))), axis=1)  # a column for no later step
            has1, has2 = seen[:, -1] >= 1, seen[:, -1] >= 2
            f1 = np.minimum(32 * w1 + np.argmax(seen >= 1, axis=1), B)
            f2 = np.minimum(32 * w1 + np.argmax(seen >= 2, axis=1), B)
            v1 = np.where(has1, st_g[lane, f1], st_g[:, B])
            v2 = np.where(has2, st_g[lane, f2], np.where(has1, st_g[:, B], 0)).astype(np.uint32)
            for c in range(w1 - 1, w0 - 1, -1):
                steps = [t for t in range(32 * c, 32 * c + 32) if t < B]
                counts = np.stack([f_g[:, t].reshape(32, 32).sum(axis=1) for t in steps])  # (step, warp)
                offsets = np.cumsum(counts, axis=1) - counts
                suffix = np.cumsum(counts.sum(axis=1)[::-1])[::-1]
                for j in range(len(steps) - 1, -1, -1):
                    fired = f_g[:, steps[j]]
                    in_warp = np.cumsum(fired.reshape(32, 32), axis=1).reshape(-1) - fired
                    slot = top - suffix[j] + offsets[j, lane // 32] + in_warp
                    keep = fired & (slot >= 0) & (slot < cap)
                    store(g, pre + slot[keep], v2[keep])
                    v2 = np.where(fired, v1, v2)
                    v1 = np.where(fired, st_g[:, steps[j]], v1)
                top -= int(suffix[0]) if len(steps) else 0
            if q == 0:
                store(g, lane, v1)
                store(g, GROUP_LANES + lane, v2)
                store(g, pre + np.arange(0, min(top, cap)), 0)
    return out, written


MIRROR_CASES = [  # (seed, n_real, B, min_len, max_len, n_groups), body word shift, max runs
    *[(case, 0, 16) for case in CASES],
    ((6, 1024, 100, 1, 12, 1), 0, 2),   # runs of two words; B not a multiple of 32
    ((10, 1024, 100, 1, 2, 1), 0, 16),  # four runs, sparse fires: 0, 1 or 2 fires after a run
    ((11, 1024, 200, 1, 3, 1), 0, 16),  # seven runs, the last one short
    ((7, 1500, 24, 1, 18, 2), 0, 16),   # every third lane never fires
    ((8, 1000, 64, 1, 18, 1), -40, 16),  # body count below the fires: slots < 0 dropped
    ((9, 1000, 64, 1, 18, 1), 40, 16),   # body count above the fires: the first slots zero
]


@pytest.mark.parametrize("case,shift,max_runs", MIRROR_CASES,
                         ids=[f"{c[0][0]}-shift{c[1]}-runs{c[2]}" for c in MIRROR_CASES])
def test_deposit_kernel_decomposition(case, shift, max_runs):
    """The CUDA kernel's run split, suffix/prefix offsets and carries from
    the first two later fires, mirrored in numpy, against the plain version
    and deposit_streams_pallas in interpret mode."""
    codes, eff, _ = _case(*case)
    seed, n_real, B = case[0], case[1], case[2]
    if seed == 7:
        eff = eff.copy()
        eff[::3] = 1  # fewer than 32 bits in B = 24 steps: these lanes never fire
        codes = np.where(eff == 1, codes & 1, codes).astype(np.uint32)
    staging, mask, body = _kernel_inputs(codes, eff, n_real, B)
    body = body + shift
    cap = B * GROUP_LANES
    got, written = _deposit_mirror(staging, mask, body, cap, max_runs)
    assert (written == 1).all()
    plain = ce.deposit_streams_plain(staging, mask, body, cap).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(pe.deposit_streams_pallas(
        pe._to_grid(jnp.asarray(staging.numpy())), pe._to_grid(jnp.asarray(mask.numpy())),
        jnp.asarray(body.numpy()), cap, interpret=True,
    ))
    np.testing.assert_array_equal(got, want)
