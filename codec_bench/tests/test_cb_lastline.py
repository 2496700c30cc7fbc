"""A run's result line, driven on the CPU at a small size: its keys and
their order, the metrics each cell reports, and the traced run's
additions. Without a card the command prints no result."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from codec_bench import run
from codec_bench.tests.tiny import CELLS, ROOT, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(root, cell, trace):
    c = run.resolve(cell, root)
    r = json.loads(json.dumps(run.run_cell(c, 2**32 + 17, 0.0, bool(trace), "cpu")))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == len(c.config["inputs"])
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = ["outputs_wrong"] + (["containers_wrong"] if c.direction == "decompress" else []) + \
        ["inputs_unchecked", "calls_failed"]
    assert r["checks"] == {n: {"value": 0, "limit": 0} for n in names}
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
        assert r["metrics"]["setup_s"]["value"] > 0


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(ROOT / "codec_bench" / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert p.returncode != 0 and p.stdout == ""
