"""What the harness loads and sets: no JAX and no JAX package in a run's
process (top-level module names compared whole, since the codec's name
begins with the JAX package's), nothing of the codec in the reference, and
no allocator or environment setting in the harness."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from codec_bench.tests.tiny import CELLS, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "huffman_tpu"}
HARNESS = [p for p in (ROOT / "codec_bench").rglob("*.py") if "tests" not in p.parts]

PROBE = """
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from codec_bench import control, e2e, gen, roofline, run, tracing
from codec_bench.reference import htpu
from codec_bench.tests.tiny import tiny_root
import tempfile
with tempfile.TemporaryDirectory() as d:
    root = tiny_root(Path(d))
    for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]:
        cell = run.resolve(w["name"], root)
        if w["name"] in {cells!r}:
            run.run_cell(cell, 5, 0.0, True, "cpu")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_a_run_loads_no_jax():
    # Every cell, traced, on the CPU.
    p = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), cells=CELLS)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "huffman_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_harness_sources_import_no_jax():
    for path in HARNESS:
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_codec():
    for path in (ROOT / "codec_bench" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "zlib", "numpy"}, path
    probe = ("import sys; sys.path.insert(0, %r); import codec_bench.reference.htpu; "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('huffman_tpu_torch', 'huffman_tpu', 'torch', 'jax')))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr


def test_harness_sets_no_allocator_or_environment_option():
    for path in HARNESS:
        text = path.read_text()
        for word in ("mallopt", "MALLOC_", "putenv", "os.environ[", "environ.setdefault",
                     "environ.update", "set_num_threads"):
            assert word not in text, (path, word)
