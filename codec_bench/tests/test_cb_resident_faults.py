"""The check fails a fault planted in a resident cell's codec for the
reason it should. There ``block_format.decompress`` of a held container
returns a tensor on the device: a byte of a copy of it altered, or half of
it left out, must reach the harness's comparison (``outputs_wrong``) with
no call failing, driven on the CPU at a small size."""

from __future__ import annotations

import json

import pytest
import torch

from codec_bench import run
from codec_bench.tests.tiny import MANIFEST, ROOT, tiny_root
from huffman_tpu_torch.container import block_format

SEED = 2**31 + 101


def _resident_cells() -> list[str]:
    configs = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in MANIFEST["configs"]}
    return [w["name"] for w in MANIFEST["workloads"]
            if configs[w["config"]]["container"] == "htpu_resident"]


def _flip(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[out.numel() // 3] ^= 0x10
    return out


def _half(out: torch.Tensor) -> torch.Tensor:
    return out[: out.numel() // 2]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def test_the_manifest_has_a_resident_cell():
    assert _resident_cells()


@pytest.mark.parametrize("fault", [_flip, _half], ids=["altered", "half"])
@pytest.mark.parametrize("cell", _resident_cells())
def test_fault_in_a_held_decode_reaches_the_comparison(root, cell, fault, monkeypatch):
    c = run.resolve(cell, root)
    real = block_format.decompress
    planted = {"calls": 0}

    def broken(blob, *args, **kwargs):
        out = real(blob, *args, **kwargs)
        if not isinstance(blob, block_format.ResidentContainer):
            return out
        planted["calls"] += 1
        return fault(out)

    monkeypatch.setattr(block_format, "decompress", broken)
    r = run.run_cell(c, SEED, 0.0, False, "cpu")
    assert planted["calls"] > 0
    assert r["correct"] is False
    assert r["checks"]["outputs_wrong"]["value"] > 0
    assert r["checks"]["calls_failed"]["value"] == 0
