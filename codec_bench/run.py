#!/usr/bin/env python3
"""The benchmark of huffman_tpu_torch, the PyTorch and CUDA codec: one cell,
one run.

    python3 codec_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells. A cell is a
configuration (``configs/<name>.json``: the deployment, its container and
settings, each input's size and content) under a traffic mix
(``traffic/<name>.json``: direction, loop, order). The container kind picks
``entries/<kind>.py``, which says how the codec is called; each per-layer
metric is read by ``metrics/<name>.py``; the end-to-end metrics are
``e2e.py``'s. A new cell, configuration or metric is new files and entries.

A run:
1. set-up: makes the inputs on the card from ``--seed`` (``gen.py``), for a
   decompress cell compresses them with the codec, and calls every payload
   in ``WARM_PASSES`` passes;
2. the window: a closed loop, one caller, passes over the payloads in a
   permutation drawn from the seed, each call ended by
   ``torch.cuda.synchronize()``, whole passes until ``--seconds`` have gone;
   it keeps the SHA-256 digests of the outputs of a sample of calls drawn
   from the seed, and of the first of each input, and drops every output
   as a caller would: holding them would change the heap the codec's next
   calls allocate from. The digests' time is taken out of the window's;
3. with ``--trace 1``, the traced passes the cell's per-layer metrics need
   (``tracing.py``), each over the payloads repeated to ``TRACE_CALLS``
   calls;
4. the check: every kept digest against the plain reference's (compress: the
   container ``reference/`` writes from the input, in worker processes;
   decompress: the input itself, and set-up's containers against those the
   reference writes), once the device memory's peak is read.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared with its limit, also
the last lines of standard error. Without a CUDA card, with fewer cards
than the cell asks for, without the codec's package in the checkout, or
with JAX or the JAX package loaded at the end, it prints no result and
exits 2.

The run sets nothing in the codec: no setting other than the
configuration's, no environment variable, no allocator option.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "huffman_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "huffman_tpu")
SMALL_REFERENCE_BYTES = 16 << 20  # below this the reference runs in this process
WARM_PASSES = 2  # the first pass after set-up still ran slower than the rest
TRACE_CALLS = 8  # the traced passes repeat the payloads to at least this many calls


def process_age() -> float:
    """Seconds since this process started (Linux's /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict

    @property
    def direction(self) -> str:
        return self.traffic["direction"]


def reader_path(root: Path, name: str) -> Path:
    metrics = root / BENCH.name / "metrics"
    path = metrics / f"{name}.py"
    return path if path.exists() else metrics / f"{name.split('.', 1)[0]}.py"


def _reports(metric: dict, cell: str, e2e_of_cell: set[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_of_cell


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH.name / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["clients"] != 1 or traffic["loop"] != "closed":
        raise SystemExit(f"traffic {w['traffic']!r}: the harness drives one caller in a closed loop")
    entry = importlib.import_module(f"{BENCH.name}.entries.{config['container']}")
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, names)]
    readers = {m["name"]: load_file(reader_path(root, m["name"]), f"metric_{i}")
               for i, m in enumerate(per_layer)}
    return Cell(name, w["chips"], config, traffic, entry, e2e, per_layer, readers)


@dataclass
class Window:
    direction: str
    setup_s: float = 0.0
    wall_s: float = 0.0
    bytes_done: int = 0
    latencies_s: list[float] = field(default_factory=list)
    attempted: int = 0
    failed: list[str] = field(default_factory=list)
    kept: list[tuple[int, bytes]] = field(default_factory=list)  # (input, SHA-256 digest)
    calls: list[int] = field(default_factory=list)  # the input of each call
    pass_rates: list[float] = field(default_factory=list)


def info(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unknown"


def make_inputs(cell: Cell, seed: int, device) -> list[bytes]:
    from codec_bench import gen

    out = []
    for i, spec in enumerate(cell.config["inputs"]):
        t = gen.make(spec["content"], spec["bytes"], seed, i, device)
        out.append(t.cpu().numpy().tobytes())
        del t
    return out


class Record(list):
    """A list whose item array is allocated once, before the window: adding
    to it then takes nothing from the C heap, which the codec's host buffers
    share, so the window's heap is the codec's alone."""

    def __init__(self, capacity: int):
        super().__init__([None] * capacity)
        self.n = 0

    def add(self, item) -> None:
        if self.n == len(self):
            self.extend([None] * len(self))
        self[self.n] = item
        self.n += 1

    def items(self) -> list:
        return self[: self.n]


def run_window(call, payloads: list[bytes], sizes: list[int], seed: int, seconds: float,
               keep_share: float, sync, direction: str) -> Window:
    order = random.Random(f"{seed}:order")
    keep = random.Random(f"{seed}:keep")
    w = Window(direction)
    capacity = 4096 + 256 * int(seconds + 1)  # calls and passes: more than a window holds
    latencies, calls, kept, rates = (Record(capacity) for _ in range(4))
    seen: set[int] = set()
    start = time.perf_counter()
    end = start
    digests_s = 0.0  # the harness's own time between calls, out of the window
    while True:
        perm = list(range(len(payloads)))
        order.shuffle(perm)
        pass_start, pass_bytes, pass_digests_s = time.perf_counter(), 0, 0.0
        for i in perm:
            t0 = time.perf_counter()
            w.attempted += 1
            try:
                out = call(payloads[i])
                sync()
            except Exception as e:  # a call that fails is counted and reported
                w.failed.append(f"{i}: {type(e).__name__}: {e}")
                out = None
            end = time.perf_counter()
            latencies.add(end - t0)
            calls.add(i)
            if out is not None:
                w.bytes_done += sizes[i]
                pass_bytes += sizes[i]
                if i not in seen or keep.random() < keep_share:
                    h0 = time.perf_counter()
                    kept.add((i, hashlib.sha256(out).digest()))
                    pass_digests_s += time.perf_counter() - h0
                seen.add(i)
            del out  # freed before the next call, as a caller that drops it would
        digests_s += pass_digests_s
        rates.add(pass_bytes / (end - pass_start - pass_digests_s) / 1e9)
        if end - start - digests_s >= seconds:
            break
    w.wall_s = end - start - digests_s
    w.latencies_s, w.calls, w.kept, w.pass_rates = (
        r.items() for r in (latencies, calls, kept, rates))
    return w


def reference_outputs(cell: Cell, inputs: list[bytes], wanted: set[int]) -> dict[int, bytes]:
    """What compress must write for each wanted input, by the plain
    reference; in worker processes where the inputs are large."""
    order = sorted(wanted)
    jobs = [cell.entry.reference_job(inputs[i], cell.config["settings"]) for i in order]
    if sum(len(inputs[i]) for i in wanted) < SMALL_REFERENCE_BYTES:
        results = [_call(job) for job in jobs]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        workers = min(len(jobs), os.cpu_count() or 1, 8)
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(_call, jobs))
    return dict(zip(order, results))


def _call(job):
    fn, args = job
    return fn(*args)


def check(cell: Cell, w: Window, inputs: list[bytes], payloads: list[bytes]) -> dict:
    """Each number compared, with its limit. A decompress cell's payloads,
    the containers its set-up made with the codec, are held to the
    reference's too: a container that breaks the format but that the codec
    reads back would otherwise pass."""
    checks = {}
    if cell.direction == "compress":
        expected = reference_outputs(cell, inputs, {i for i, _ in w.kept})
    else:
        expected = dict(enumerate(inputs))
        made = reference_outputs(cell, inputs, set(range(len(inputs))))
        checks["containers_wrong"] = {"value": sum(payloads[i] != c for i, c in made.items()),
                                      "limit": 0}
    digests = {i: hashlib.sha256(x).digest() for i, x in expected.items()}
    wrong = sum(digest != digests[i] for i, digest in w.kept)
    unchecked = len(set(range(len(inputs))) - {i for i, _ in w.kept})
    return {
        "outputs_wrong": {"value": wrong, "limit": 0},
        **checks,
        "inputs_unchecked": {"value": unchecked, "limit": 0},
        "calls_failed": {"value": len(w.failed), "limit": 0},
    }


def traced_passes(cell: Cell, call, payloads, pass_bytes: int, pass_wall_s: float,
                  stream_words, card: str, sync):
    """The traced passes the cell's per-layer metrics need, and the
    readers' view of them."""
    import torch

    from codec_bench import tracing

    program = importlib.import_module(PROGRAM)
    needs = set().union(*(r.NEEDS for r in cell.readers.values())) | {"profile"}
    t = tracing.Traced(cell.direction, cell.config["container"], card,
                       Path(program.__file__).resolve().parent, pass_bytes, pass_wall_s,
                       stream_words)
    targets = tracing.load_targets(ROOT / BENCH.name)

    def one_pass(annotate: bool):
        def run():
            calls = []
            for p in payloads:
                t0 = time.perf_counter()
                if annotate:
                    with torch.profiler.record_function(tracing.CALL):
                        call(p)
                        sync()
                else:
                    call(p)
                    sync()
                calls.append((t0, time.perf_counter()))
            return calls
        return run

    with tracing.Spans(targets):
        t.device = tracing.profile(one_pass(True))
    if "cprofile" in needs:
        t.cprofile = tracing.cprofile(one_pass(False))
    return t


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, call=None) -> dict:
    """One run of ``cell``; returns the result object.
    ``t_start`` is the perf_counter reading of the process's start;
    ``call``, where given, takes the codec's place in the window (the
    control, ``control.py``)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    ht = importlib.import_module(PROGRAM)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    settings = cell.config["settings"]
    info(f"at {time.perf_counter() - t_start:.3f} s: {card}, the codec imported")

    t0 = time.perf_counter()
    inputs = make_inputs(cell, seed, dev)
    sizes = [len(x) for x in inputs]
    info(f"inputs: {len(inputs)}, {sum(sizes)} bytes, made in {time.perf_counter() - t0:.3f} s")
    if cell.direction == "compress":
        payloads = inputs
    else:
        t0 = time.perf_counter()
        make = cell.entry.program(ht, "compress", settings, dev)
        payloads = [make(x) for x in inputs]
        sync()
        info(f"containers made in {time.perf_counter() - t0:.3f} s")
    call = call or cell.entry.program(ht, cell.direction, settings, dev)
    t0 = time.perf_counter()
    for _ in range(WARM_PASSES):  # every shape the window uses
        warm = []
        for p in payloads:
            try:
                warm.append(call(p))
            except Exception as e:  # the window counts and reports such calls
                info(f"warm-up call failed: {type(e).__name__}: {e}")
                warm.append(b"")
        sync()
    info(f"warm-up, {WARM_PASSES} passes: {time.perf_counter() - t0:.3f} s")
    containers = payloads if cell.direction == "decompress" else warm
    for spec, x, c in zip(cell.config["inputs"], inputs, containers):
        info(f"input {spec['name']}: {len(x)} bytes, container {len(c)} bytes, "
             f"ratio {len(c) / len(x):.6f}")
    stream_words = None
    if trace:
        try:
            stream_words = sum(cell.entry.stream_words(c) for c in containers)
        except ValueError as e:  # the check will report the container
            info(f"stream words not counted: {e}")
    del warm, containers

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    w = run_window(call, payloads, sizes, seed, seconds, cell.traffic["keep_share"], sync,
                   cell.direction)
    w.setup_s = setup_s
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    power = card_line() if on_card else "cpu"
    info(f"card: {power}; set-up {setup_s:.3f} s")
    info(f"window: {w.attempted} calls, {w.bytes_done} bytes in {w.wall_s:.6f} s "
         f"({len(w.kept)} digests taken apart); "
         f"per pass GB/s: {' '.join(f'{r:.4f}' for r in w.pass_rates)}")
    for i, spec in enumerate(cell.config["inputs"]):
        ms = sorted(1e3 * t for t, j in zip(w.latencies_s, w.calls) if j == i)
        if ms:
            info(f"latency of {spec['name']}: {len(ms)} calls, ms min {ms[0]:.3f} "
                 f"median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}")

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": card,
                   "count": cell.chips, "memory_peak_bytes": memory_peak, "power_limit": power}
    result: dict = {}
    if trace:
        # A pass's time in the window, where nothing is instrumented.
        pass_wall_s = w.wall_s * sum(sizes) / w.bytes_done if w.bytes_done else 0.0
        reps = -(-TRACE_CALLS // len(payloads))
        t = traced_passes(cell, call, payloads * reps, reps * sum(sizes), reps * pass_wall_s,
                          None if stream_words is None else reps * stream_words, card, sync)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(t, m["name"].partition(".")[2])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = t.device.busy_s
        device_info["window_s"] = t.device.window_s
        result["breakdown"] = t.device.breakdown()
    else:
        from codec_bench import e2e

        metrics = {}
        for m in cell.end_to_end:
            v = e2e.value(m["name"], w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check(cell, w, inputs, payloads)
    info(f"check: {len(w.kept)} outputs' digests against the reference's in "
         f"{time.perf_counter() - t0:.3f} s")
    for f in w.failed[:5]:
        info(f"failed call {f}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": w.attempted, "failed": len(w.failed),
            "metrics": metrics, "device": device_info, **result, "checks": checks}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    age = process_age()
    t_start = time.perf_counter() - age
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The checkout's root in place of this script's folder, whose modules
    # would otherwise shadow top-level names.
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    cell = resolve(args.workload)
    import torch

    info(f"at {time.perf_counter() - t_start:.3f} s: torch imported")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        info(f"needs {cell.chips} CUDA card(s): torch.cuda.is_available() is "
             f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    try:
        program = importlib.import_module(PROGRAM)
    except ImportError as e:
        info(f"the codec is not in this checkout: {e}")
        return 2
    if ROOT not in Path(program.__file__).resolve().parents:
        info(f"{PROGRAM} was imported from {program.__file__}, outside {ROOT}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        info(f"loaded in this process: {', '.join(found)}")
        return 2
    for name, c in result["checks"].items():
        info(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
