"""The port's distribution layer (huffman_tpu_torch/parallel/pipeline.py)
against the JAX package's, on two ranks.

Two worker processes (tests/torch_parallel_worker.py, which import no
JAX) form one gloo group on the CPU and run every case once per module,
each rank on its shard of the inputs made here from seeds. Meanwhile this
process runs the JAX functions on a two-device mesh of the virtual CPU
devices (interpret mode where tests/test_parallel.py uses it). The
concatenated local outputs and the replicated outputs must equal the JAX
ones exactly. Each worker gets 120 s, so a hang fails here quickly.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from huffman_tpu.codebook import Codebook
from huffman_tpu.constants import MAX_SYMBOLS
from huffman_tpu.container import block_format as bf
from huffman_tpu.container import interleave as il
from huffman_tpu.container import sharded
from huffman_tpu.ops import pallas_decode as pd
from huffman_tpu.ops.tables import device_tables
from huffman_tpu.parallel import pipeline as pp
from huffman_tpu_torch.codebook import Codebook as TorchCodebook

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"
WORLD = 2
TIMEOUT_S = 120


def _blocks(seed, nblocks=16, B=128):
    """tests/test_parallel.py's ``_data``: a 100-symbol alphabet, 13
    padding symbols at the end."""
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(MAX_SYMBOLS, size=100, replace=False)
    n_pairs = nblocks * B - 13
    symbols = rng.choice(alphabet, size=n_pairs).astype(np.int32)
    padded = np.zeros(nblocks * B, dtype=np.int32)
    padded[:n_pairs] = symbols
    valid = np.arange(nblocks * B) < n_pairs
    return symbols, padded.reshape(nblocks, B), valid.reshape(nblocks, B), n_pairs


def _groups(symbols, cb, n_real, B, ngroups):
    """Interleaved group streams of ``symbols`` by the JAX package's host
    protocol: (stacked (ngroups * rows, 128) u32, (ngroups, 4) meta)."""
    n_lanes = ngroups * pd.GROUP_LANES
    slab, _, lens = bf._encode_slab_numpy(symbols, cb, n_lanes, B)
    min_len = int(cb.lengths[cb.lengths > 0].min())
    eff = il.effective_lengths(lens, symbols.size, min_len, n_lanes, B)
    stacked, _ = il.pad_streams(il.build_streams(slab, eff, n_real))
    meta = np.zeros((ngroups, 4), dtype=np.int32)
    meta[:, 0] = np.clip(n_real - pd.GROUP_LANES * np.arange(ngroups), 0, pd.GROUP_LANES)
    return stacked, meta


def _decode_case(inputs, refs, mesh, name, symbols, B, ngroups, n_real, multi):
    cb = Codebook.from_frequencies(np.bincount(symbols, minlength=MAX_SYMBOLS))
    stacked, meta = _groups(symbols, cb, n_real, B, ngroups)
    symtab, sym_rows, translate = pd.build_symtab(cb.sym_order)
    inputs.update({
        f"{name}.streams": stacked.reshape(ngroups, -1), f"{name}.n_real": meta[:, 0],
        f"{name}.lengths": cb.lengths, f"{name}.n_steps": np.array(B),
        f"{name}.translate": np.array(translate),
    })
    args = (
        jnp.asarray(stacked), jnp.asarray(cb.lj_limit),
        jnp.asarray((cb.base & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray(symtab), jnp.asarray(meta),
    )
    kw = dict(
        n_steps=B, stream_rows=stacked.shape[0] // ngroups, sym_rows=sym_rows,
        max_len=max(cb.max_len, 1), translate=translate,
        min_len=int(cb.lengths[cb.lengths > 0].min()), interpret=True, multi=multi,
    )
    if not translate:
        kw["sym_order_dev"] = jnp.asarray(cb.sym_order.astype(np.int32))
    for packed in (True, False):
        out = pp.distributed_decode_groups(mesh, *args, packed_out=packed, **kw)
        refs[f"{name}.packed{int(packed)}"] = np.asarray(out)
    return translate


def _streams_case(inputs, refs, mesh, name, symbols, n_lanes, B, max_len):
    padded = np.zeros(n_lanes * B, np.int32)
    padded[: symbols.size] = symbols
    inputs.update({
        f"{name}.padded": padded.reshape(n_lanes, B), f"{name}.n_pairs": np.array(symbols.size),
        f"{name}.max_len": np.array(max_len),
    })
    streams, counts, lengths, ok = pp.distributed_encode_streams(
        mesh, jnp.asarray(padded), jnp.asarray(symbols.size, jnp.int32), B,
        words_cap=B * pd.GROUP_LANES, max_len=max_len, interpret=True,
    )
    refs.update({f"{name}.streams": np.asarray(streams), f"{name}.counts": np.asarray(counts),
                 f"{name}.lengths": np.asarray(lengths), f"{name}.ok": np.asarray(ok)})


def _cases(mesh) -> tuple[dict, dict]:
    """(inputs for the workers, the JAX functions' outputs)."""
    inputs, refs = {}, {}

    symbols, _, _, _ = _blocks(0)
    inputs["hist.symbols"] = symbols
    refs["hist.hist"] = np.asarray(pp.distributed_histogram(mesh, jnp.asarray(symbols)))

    symbols, padded, valid, n_pairs = _blocks(1)
    cb = Codebook.from_frequencies(np.bincount(symbols, minlength=MAX_SYMBOLS))
    t = device_tables(cb)
    B = padded.shape[1]
    inputs.update({"step.padded": padded, "step.n_pairs": np.array(n_pairs),
                   "step.lengths": cb.lengths, "step.W": np.array(B)})
    step = jax.jit(pp.compress_decompress_step(mesh), static_argnames=("W", "B"))
    hist, slab, bits, ok = step(
        jnp.asarray(padded), jnp.asarray(valid), t.enc_codes, t.enc_lens, t.lj_limit,
        t.base, t.sym_order, jnp.asarray(t.max_len, jnp.int32), W=B, B=B,
    )
    refs.update({"step.hist": np.asarray(hist)[:MAX_SYMBOLS], "step.slab": np.asarray(slab),
                 "step.bits": np.asarray(bits), "step.ok": np.asarray(ok)})
    refs["step.expected_bits"] = np.array(
        TorchCodebook.from_lengths(cb.lengths).expected_bits(np.bincount(symbols, minlength=MAX_SYMBOLS)))

    symbols, padded, valid, n_pairs = _blocks(2)
    cb = Codebook.from_frequencies(np.bincount(symbols, minlength=MAX_SYMBOLS))
    t = device_tables(cb)
    inputs.update({"encdec.padded": padded, "encdec.n_pairs": np.array(n_pairs),
                   "encdec.lengths": cb.lengths})
    slab, bits = pp.distributed_encode(
        mesh, jnp.asarray(padded), jnp.asarray(valid), t.enc_codes, t.enc_lens, B
    )
    out = pp.distributed_decode(
        mesh, slab, t.lj_limit, t.base, t.sym_order, jnp.asarray(t.max_len, jnp.int32), B
    )
    refs.update({"encdec.slab": np.asarray(slab), "encdec.bits": np.asarray(bits),
                 "encdec.decoded": np.asarray(out), "encdec.symbols": symbols})

    # tests/test_parallel.py's two group-decode cases, and the full
    # alphabet in rank mode (every one of the 65,536 symbols present).
    L = pd.GROUP_LANES
    rng = np.random.default_rng(21)
    n_real, B = 8 * L - 37, 16
    alpha = rng.choice(MAX_SYMBOLS, 120, replace=False)
    sym = rng.choice(alpha, n_real * B - 5).astype(np.uint16)
    assert _decode_case(inputs, refs, mesh, "groups_translate", sym, B, 8, n_real, 1)
    rng = np.random.default_rng(22)
    n_real, B = 8 * L - 11, 8
    alpha = rng.choice(MAX_SYMBOLS, 6000, replace=False)
    sym = rng.choice(alpha, n_real * B - 3).astype(np.uint16)
    assert not _decode_case(inputs, refs, mesh, "groups_rank6000", sym, B, 8, n_real,
                            pd.DEFAULT_MULTI_RANK)
    rng = np.random.default_rng(23)
    n_real, B = 8 * L - 5, 16
    sym = rng.permutation(np.concatenate([
        np.arange(MAX_SYMBOLS), rng.zipf(1.3, n_real * B - 7 - MAX_SYMBOLS) % MAX_SYMBOLS,
    ])).astype(np.uint16)
    assert np.unique(sym).size == MAX_SYMBOLS
    assert not _decode_case(inputs, refs, mesh, "groups_rank_full", sym, B, 8, n_real,
                            pd.DEFAULT_MULTI_RANK)

    # tests/test_parallel.py's fused-encode cases (200 symbols; 45
    # Fibonacci-skewed symbols at a 32-bit limit; 12,000 symbols), and the
    # full alphabet.
    B, n_lanes = 16, 8 * L
    rng = np.random.default_rng(31)
    alpha = rng.choice(MAX_SYMBOLS, 200, replace=False)
    _streams_case(inputs, refs, mesh, "streams_200",
                  rng.choice(alpha, n_lanes * B - 77).astype(np.uint16), n_lanes, B, 18)
    rng = np.random.default_rng(41)
    alpha = rng.choice(MAX_SYMBOLS, 45, replace=False)
    w = np.array([1.55 ** -i for i in range(45)])
    _streams_case(inputs, refs, mesh, "streams_deep",
                  rng.choice(alpha, n_lanes * B - 3, p=w / w.sum()).astype(np.uint16),
                  n_lanes, B, 32)
    rng = np.random.default_rng(53)
    alpha = rng.choice(MAX_SYMBOLS, 12000, replace=False)
    p = 1.0 / np.arange(1, 12001) ** 0.7
    _streams_case(inputs, refs, mesh, "streams_12k",
                  rng.choice(alpha, n_lanes * B - 11, p=p / p.sum()).astype(np.uint16),
                  n_lanes, B, 18)
    rng = np.random.default_rng(54)
    full = rng.permutation(np.concatenate([
        np.arange(MAX_SYMBOLS), rng.zipf(1.2, n_lanes * B - 9 - MAX_SYMBOLS) % MAX_SYMBOLS,
    ])).astype(np.uint16)
    _streams_case(inputs, refs, mesh, "streams_full", full, n_lanes, B, 18)

    rng = np.random.default_rng(4)
    data = (rng.zipf(1.4, size=100001) % 240).astype(np.uint8)
    inputs["htpx.data"] = data
    refs["htpx.blob"] = np.frombuffer(
        sharded.compress(data.tobytes(), n_shards=4, codebook_mode="global", backend="numpy"),
        np.uint8,
    )
    return inputs, refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the two ranks, compute the JAX outputs meanwhile, and return
    (the JAX outputs, each rank's outputs)."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs two (virtual) JAX devices")
    mesh = pp.data_mesh(jax.devices()[:WORLD])
    d = tmp_path_factory.mktemp("ranks")
    inputs, refs = _cases(mesh)
    np.savez(d / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "2"
    deadline = time.monotonic() + TIMEOUT_S
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(d), str(r), str(WORLD)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(WORLD)
    ]
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r}: no result within {TIMEOUT_S} s")
                continue
            if p.returncode != 0:
                errors.append(f"rank {r}: exit {p.returncode}\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        pytest.fail("\n".join(errors))
    return refs, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _replicated(run, key):
    refs, ranks = run
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key], refs[key], err_msg=f"{key}, rank {r}")


def _local(run, key):
    refs, ranks = run
    got = np.concatenate([out[key] for out in ranks])
    np.testing.assert_array_equal(got.view(np.uint32), refs[key].view(np.uint32), err_msg=key)


def test_ranks_import_no_jax(run):
    _, ranks = run
    assert [str(out["modules.foreign"]) for out in ranks] == [""] * WORLD


def test_distributed_histogram_matches_jax(run):
    _replicated(run, "hist.hist")


def test_full_distributed_step_matches_jax(run):
    refs, ranks = run
    for key in ("step.hist", "step.bits", "step.ok"):
        _replicated(run, key)
    _local(run, "step.slab")
    assert int(ranks[0]["step.ok"]) == 1
    assert int(ranks[0]["step.bits"].sum()) == int(refs["step.expected_bits"])


def test_distributed_encode_decode_matches_jax(run):
    refs, ranks = run
    _replicated(run, "encdec.bits")
    _local(run, "encdec.slab")
    _local(run, "encdec.decoded")
    got = np.concatenate([out["encdec.decoded"] for out in ranks]).reshape(-1)
    np.testing.assert_array_equal(got[: refs["encdec.symbols"].size], refs["encdec.symbols"])


@pytest.mark.parametrize("case", ["groups_translate", "groups_rank6000", "groups_rank_full"])
@pytest.mark.parametrize("packed", [1, 0])
def test_distributed_decode_groups_matches_jax(run, case, packed):
    """Translate mode, rank mode at 6,000 symbols, and rank mode at the
    full 65,536-symbol alphabet (K2 on the packed pairs, K5 unpacked)."""
    _local(run, f"{case}.packed{packed}")


@pytest.mark.parametrize("case", ["streams_200", "streams_deep", "streams_12k", "streams_full"])
def test_distributed_encode_streams_matches_jax(run, case):
    refs, ranks = run
    for field in ("counts", "lengths", "ok"):
        _replicated(run, f"{case}.{field}")
    counts = refs[f"{case}.counts"]
    got = [g for out in ranks for g in out[f"{case}.streams"]]
    assert len(got) == counts.size
    for g, (mine, theirs) in enumerate(zip(got, refs[f"{case}.streams"])):
        np.testing.assert_array_equal(
            mine[: counts[g]].view(np.uint32), theirs[: counts[g]], err_msg=f"{case} group {g}"
        )
    if case == "streams_full":
        assert int((refs[f"{case}.lengths"] > 0).sum()) == MAX_SYMBOLS


def test_htpx_global_codebook_on_a_group_equals_the_groupless_archive(run):
    """tests/test_sharded.py::test_global_codebook_on_mesh for the port:
    each rank histograms half of the symbols and the counts are
    all-reduced; the archive equals the JAX package's built without a
    mesh, byte for byte."""
    _replicated(run, "htpx.blob")


@pytest.mark.parametrize("case", ["unequal_shards", "partial_group", "uneven_split", "device"])
def test_every_rank_raises_value_error(run, case):
    _, ranks = run
    for r, out in enumerate(ranks):
        assert str(out[f"errors.{case}"]).startswith("ValueError"), (case, r)
    assert [out["errors.after"].tolist() for out in ranks] == [[1, 1]] * WORLD
