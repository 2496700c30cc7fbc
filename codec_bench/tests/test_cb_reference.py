"""The plain reference against the codec's CPU path, byte for byte, at
small sizes: HTPU v2 containers by both compress routes (the odd tail,
partial groups, narrow and full alphabets, one symbol, incompressible
input). The test imports both; the reference imports
nothing of the codec."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import huffman_tpu_torch as ht
from codec_bench import gen
from codec_bench.reference import htpu
from huffman_tpu_torch.codebook import package_merge_lengths
from huffman_tpu_torch.container import block_format

CPU = torch.device("cpu")


def _zipf(n_bytes, n_unique, seed, expo=0.65):
    content = {"kind": "zipf_pairs", "n_unique": n_unique, "zipf": expo, "base_seed": seed,
               "shuffle_bytes": n_bytes + 1}
    return gen.make(content, n_bytes, seed, 0, CPU).numpy().tobytes()


def _silesia(n_bytes, seed):
    content = {"kind": "silesia_like", "text_share": 0.8, "text_pairs": 3000,
               "text_zipf": 1.1, "text_alphabet": 16384, "noise_pairs": 1024,
               "base_seed": seed, "shuffle_bytes": n_bytes + 1}
    return gen.make(content, n_bytes, seed, 0, CPU).numpy().tobytes()


CASES = {
    "silesia_odd": lambda: _silesia(300001, 1),
    "silesia_even": lambda: _silesia(262144, 2),
    "zipf300_partial_group": lambda: _zipf(1024 * 1024 + 1026, 300, 3),
    "full_alphabet_odd": lambda: _zipf(200001, 65536, 4),
    "deep_codes": lambda: _zipf(400000, 20000, 5, 1.4),
    "one_symbol": lambda: b"\x01\x02" * 5000 + b"\x07",
    "one_pair_block": lambda: b"ab",
    "one_byte": lambda: b"z",
    "empty": lambda: b"",
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_container_equals_the_codecs(case):
    data = CASES[case]()
    blob = ht.compress(data, device="cpu")
    assert htpu.encode(data) == blob
    assert htpu.decode(blob) == data


@pytest.mark.parametrize("case", ["silesia_odd", "zipf300_partial_group", "full_alphabet_odd"])
def test_reference_container_equals_the_fused_route(case, monkeypatch):
    data = CASES[case]()
    monkeypatch.setattr(block_format, "DEVICE_MIN_PAIRS", 1)
    blob = ht.compress(data, device="cpu")
    assert htpu.encode(data) == blob


@pytest.mark.parametrize("block_symbols,max_code_len", [(512, 18), (511, 18), (256, 16), (1024, 20)])
def test_reference_follows_the_settings(block_symbols, max_code_len):
    data = _zipf(300001, 5000, 6, 1.2)
    blob = ht.compress(data, device="cpu", block_symbols=block_symbols, max_code_len=max_code_len)
    assert htpu.encode(data, block_symbols, max_code_len) == blob
    assert htpu.decode(blob) == data


@pytest.mark.parametrize("seed", range(6))
def test_code_lengths_equal_the_codecs_package_merge(seed):
    rng = np.random.default_rng(seed)
    n = [2, 3, 40, 700, 5000, 65536][seed]
    counts = np.zeros(65536, dtype=np.int64)
    symbols = rng.choice(65536, n, replace=False)
    # Many equal counts, so ties between leaves and packages occur.
    counts[symbols] = rng.integers(1, 6, n) ** rng.integers(1, 4, n)
    for limit in (16, 18, 24):
        assert np.array_equal(htpu.code_lengths(counts, limit), package_merge_lengths(counts, limit))


def test_controls_break_their_guarantee():
    data = _silesia(100001, 8)
    blob = htpu.encode(data)
    assert htpu.encode(data, crc=False) != blob
    assert htpu.decode(blob, reorder=False, verify=False) != data
    mid = len(blob) // 2
    with pytest.raises(ValueError):
        htpu.decode(blob[:mid] + bytes([blob[mid] ^ 1]) + blob[mid + 1:])
