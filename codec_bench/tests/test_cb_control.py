"""The check fails what it should, driven on the CPU at a small size: the
control (the reference with a guarantee broken, in the codec's place) and
each fault a cell can have, planted in the codec under the timed path: an
answer altered where it is made, and half of an answer left out; and, in a
decompress cell, set-up's containers off the format. A sound run of the
same cell passes."""

from __future__ import annotations

import pytest

from codec_bench import run
from codec_bench.tests.tiny import CELLS, tiny_root
from huffman_tpu_torch.container import block_format

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    c = run.resolve(cell, root)
    control = c.entry.control(c.direction, c.config["settings"])
    r = run.run_cell(c, SEED, 0.0, False, "cpu", call=control)
    assert r["correct"] is False
    assert r["checks"]["outputs_wrong"]["value"] + r["checks"]["calls_failed"]["value"] > 0


def _flip(out: bytes) -> bytes:
    i = len(out) // 3
    return out[:i] + bytes([out[i] ^ 0x10]) + out[i + 1:]


def _half(out: bytes) -> bytes:
    return out[: len(out) // 2]


@pytest.mark.parametrize("fault", [_flip, _half], ids=["altered", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_codec_fails(root, cell, fault, monkeypatch):
    c = run.resolve(cell, root)
    name = c.direction
    real = getattr(block_format, name)
    planted = {"on": False}

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        return fault(out) if planted["on"] else out

    monkeypatch.setattr(block_format, name, broken)
    # The fault sits under the timed path only: set-up makes its containers
    # with the sound codec, and the window's calls go through the fault.
    program = c.entry.program

    def faulty_program(ht, direction, settings, device):
        call = program(ht, direction, settings, device)
        if direction != name:
            return call

        def timed(payload):
            planted["on"] = True
            try:
                return call(payload)
            finally:
                planted["on"] = False
        return timed

    monkeypatch.setattr(c.entry, "program", faulty_program)
    r = run.run_cell(c, SEED, 0.0, False, "cpu")
    assert r["correct"] is False
    assert r["checks"]["outputs_wrong"]["value"] + r["checks"]["calls_failed"]["value"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".decompress")])
def test_container_off_the_format_fails(root, cell, monkeypatch):
    # Set-up's containers carry bytes the format does not have, which the
    # codec reads past: every restored output is right, the containers not.
    c = run.resolve(cell, root)
    real = block_format.compress
    monkeypatch.setattr(block_format, "compress", lambda *a, **k: real(*a, **k) + bytes(8))
    r = run.run_cell(c, SEED, 0.0, False, "cpu")
    assert r["checks"]["outputs_wrong"]["value"] == 0
    assert r["checks"]["containers_wrong"]["value"] == len(c.config["inputs"])
    assert r["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes(root, cell):
    r = run.run_cell(run.resolve(cell, root), SEED, 0.0, False, "cpu")
    assert r["correct"] is True
