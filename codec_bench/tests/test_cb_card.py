"""Short runs of each cell on the card, as the benchmark's command runs
them, and a run in a directory without the codec, which must print no
result. Marked ``cuda``: they skip without a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from codec_bench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cwd, cell, seed, trace=0):
    return subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=cwd,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(card, cell):
    p = _run(ROOT, cell, 2**32 + CELLS.index(cell))
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, p.stderr[-4000:]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"]["setup_s"]["value"] > 0 and len(r["metrics"]) >= 2


@pytest.mark.cuda
def test_no_result_without_the_codec(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "codec_bench", tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, CELLS[0], 1)
    assert p.returncode != 0 and p.stdout == ""
