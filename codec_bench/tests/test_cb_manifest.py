"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of every cell, configuration, traffic mix and metric by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from codec_bench import run
from codec_bench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if (ROOT / w).is_file()]
    assert files and all(any(f.startswith(p + "/") for p in MANIFEST["paths"]) for f in files)
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        assert (ROOT / c["file"]).is_file()
        names.append(("config", c["name"]))
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["config"])
        assert NAME.fullmatch(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        names.append(("cell", w["name"]))
    assert len(pairs) == len(MANIFEST["workloads"])
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(("metric", m["name"]))
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        names.append(("metric", m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in CELLS for c in m.get("workloads", []))
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_metrics_move(cell):
    c = run.resolve(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert hasattr(c.readers[m["name"]], "read") and c.readers[m["name"]].NEEDS
    assert c.config["inputs"] and c.traffic["direction"] in ("compress", "decompress")


def test_a_cell_added_as_files_and_entries_is_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "codec_bench", tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "codec_bench"
    small = json.loads((bench / "configs" / "bench_headline.json").read_text())
    small["inputs"] = [{"name": "romeo", "bytes": 163921, "content": small["inputs"][0]["content"]}]
    (bench / "configs" / "small_files.json").write_text(json.dumps(small))
    (bench / "traffic" / "decompress_once.json").write_text(json.dumps(
        {"direction": "decompress", "clients": 1, "loop": "closed",
         "order": "every input once a pass", "keep_share": 1.0}))
    (bench / "metrics" / "calls_per_pass.py").write_text(
        "NEEDS = {'profile'}\n\ndef read(t, qualifier):\n    return None\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "small_files", "source": "https://example.org/corpus",
                                "file": "codec_bench/configs/small_files.json",
                                "reduced": [], "why": "small files"})
    manifest["workloads"].append({"name": "small_files.decompress_once", "config": "small_files",
                                  "traffic": "decompress_once", "chips": 1, "why": "per-call cost"})
    manifest["end_to_end"][0]["workloads"].append("small_files.decompress_once")
    manifest["per_layer"].append({"name": "calls_per_pass", "unit": "calls", "better": "lower",
                                  "source": "program_span", "layer": "front end",
                                  "moves": "decompress_GBps",
                                  "workloads": ["small_files.decompress_once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = run.resolve("small_files.decompress_once", tmp_path)
    assert [(s["name"], s["bytes"]) for s in cell.config["inputs"]] == [("romeo", 163921)]
    assert cell.traffic["keep_share"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["calls_per_pass"]
    assert cell.readers["calls_per_pass"].NEEDS == {"profile"}
    assert {m["name"] for m in cell.end_to_end} == {"decompress_GBps", "setup_s"}
    # The cells already there resolve as before.
    for name in CELLS:
        assert run.resolve(name, tmp_path).per_layer == run.resolve(name).per_layer
