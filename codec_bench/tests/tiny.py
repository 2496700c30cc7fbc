"""A copy of the benchmark with its inputs cut to a size that the codec's
CPU path runs in seconds, for tests of the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# Per configuration: each input's size, odd so that the tail byte is in.
SIZES = {"bench_headline": lambda i, b: 300001}

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def tiny_root(tmp: Path) -> Path:
    """A root with BENCHMARK.json and the benchmark's folder, configurations
    cut to size."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "codec_bench", tmp / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp / "codec_bench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        for i, spec in enumerate(config["inputs"]):
            spec["bytes"] = SIZES[path.stem](i, spec["bytes"])
        path.write_text(json.dumps(config))
    return tmp
