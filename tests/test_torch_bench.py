"""The port's measurement modules (huffman_tpu_torch/utils/{timing,
profiling,benchmark}.py) and bench_torch.py, on the CPU at 64 KiB: the
timers count their calls and return positive times, the profiler writes a
trace, and each bench line's bit-exactness check passes before it times
(and fails on a wrong reference). The bench itself runs on a card only;
the last test drives one small rung there and skips without one."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import huffman_tpu_torch
from huffman_tpu_torch.utils import benchmark, profiling, timing

REPO = Path(__file__).resolve().parent.parent
SIZE = 64 << 10


def _bench():
    spec = importlib.util.spec_from_file_location("bench_torch", REPO / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counted(fn):
    calls = []

    def wrapper(*args):
        calls.append(1)
        return fn(*args)

    return wrapper, calls


def test_holds_cuda_finds_no_card_tensor_on_the_host():
    assert not timing.holds_cuda({"x": torch.arange(3)}, [torch.zeros(1)], {"a": (torch.ones(2),)})
    assert not timing.holds_cuda(None, "text", 3)


@pytest.mark.parametrize("iters,warmup", [(1, 0), (5, 2)])
def test_time_fn_counts_its_calls(iters, warmup):
    fn, calls = _counted(lambda x: (x * 3).sum())
    sec = timing.time_fn(fn, torch.arange(SIZE), iters=iters, warmup=warmup)
    assert sec > 0 and len(calls) == iters + warmup


def test_wall_times_counts_its_calls():
    fn, calls = _counted(lambda x: x.sort())
    times = timing.wall_times(fn, torch.arange(SIZE).flip(0), iters=7, warmup=1)
    assert len(times) == 7 and min(times) > 0 and len(calls) == 8


@pytest.mark.parametrize("iters,reps", [(1, 1), (20, 3)])
def test_amortized_time_fn_counts_its_calls(iters, reps):
    fn, calls = _counted(lambda x: torch.cumsum(x, 0))
    arg = torch.arange(SIZE, dtype=torch.int32)
    times = timing.amortized_times(fn, arg, iters=iters, reps=reps)
    assert len(times) == reps and min(times) > 0
    assert len(calls) == 1 + iters * reps  # one warm-up call
    fn, calls = _counted(lambda x: torch.cumsum(x, 0))
    assert timing.amortized_time_fn(fn, arg, iters=iters, reps=reps) > 0
    assert len(calls) == 1 + iters * reps


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        torch.arange(SIZE).sort()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("sort" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_trace_does_not_swallow_a_failure(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(tmp_path):
            1 / 0  # noqa: B018


def test_bench_result_line():
    r = benchmark.BenchResult.from_times("m", 2_000_000_000, [2.0, 1.0, 4.0], "cpu")
    assert (r.seconds, r.gbps, r.spread, r.reps, r.device) == (2.0, 1.0, (0.5, 2.0), 3, "cpu")
    assert json.loads(r.json_line()) == {
        "metric": "m", "value": 1.0, "unit": "GB/s", "spread": [0.5, 2.0], "reps": 3, "device": "cpu",
    }
    assert "1.00 GB/s" in str(r)
    assert benchmark.device_line("cpu") == "cpu"
    from huffman_tpu_torch import corpus

    assert benchmark.silesia_like is corpus.silesia_like and benchmark.zipf_pairs is corpus.zipf_pairs


def _inputs():
    return {
        "silesia_like": benchmark.silesia_like(SIZE, seed=7).tobytes(),     # rank-tier decode
        "zipf300": benchmark.zipf_pairs(SIZE, 300, np.random.default_rng(5)).tobytes(),  # translate
    }


def _check(r, name, reps):
    assert r.name == name
    assert r.device == "cpu" and r.reps == reps
    assert r.seconds > 0 and r.gbps == pytest.approx(SIZE / r.seconds / 1e9)
    assert 0 < r.spread[0] <= r.gbps <= r.spread[1]


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_bench_rung_checks_then_times_on_cpu(name):
    b = _bench()
    data = _inputs()[name]
    results = b.bench_rung(data, name, "cpu", reps=2, iters=2)
    kinds = ("decode", "encode", "compress", "decompress")
    assert len(results) == 4
    for r, kind in zip(results, kinds):
        _check(r, f"huffman_{kind}_throughput_{name}", 2)


def test_bench_lines_reject_a_wrong_reference():
    """Each line's check bites: against another input's container the
    decode, encode and end-to-end lines raise before timing."""
    b = _bench()
    data, other = _inputs()["silesia_like"], _inputs()["zipf300"]
    wrong = huffman_tpu_torch.compress(other, "cpu")
    dev = torch.device("cpu")
    with pytest.raises(AssertionError, match="decoded pairs differ"):
        b.decode_line(data, wrong, "t", dev, "cpu", iters=1, reps=1)
    with pytest.raises(AssertionError, match="encode streams differ"):
        b.encode_line(data, wrong, "t", dev, "cpu", iters=1, reps=1)
    with pytest.raises(AssertionError, match="container differs"):
        b.end_to_end_lines(data, wrong, "t", dev, "cpu", reps=1)


def test_bench_refuses_an_incompressible_rung():
    b = _bench()
    data = np.random.default_rng(0).integers(0, 256, SIZE, dtype=np.uint8).tobytes()
    with pytest.raises(ValueError, match="does not compress"):
        b.bench_rung(data, "random", "cpu", reps=1, iters=1)


def test_bench_main_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    b = _bench()
    assert b.main() != 0
    assert "no CUDA card" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="cuda"):
        b.bench_rung(_inputs()["zipf300"], "t")  # the card by default, never the CPU


def test_bench_rungs_are_the_documented_corpora():
    b = _bench()
    assert b.BYTES == 32 << 20 and list(b.RUNGS) == ["silesia_like_32MB", "wide30k_32MB", "zipf65536_32MB"]
    n = 4096
    assert b.RUNGS["silesia_like_32MB"](n).tobytes() == benchmark.silesia_like(n, seed=7).tobytes()
    assert b.RUNGS["wide30k_32MB"](n).tobytes() == benchmark.zipf_pairs(
        n, 30000, np.random.default_rng(3)).tobytes()
    assert b.RUNGS["zipf65536_32MB"](n).tobytes() == benchmark.zipf_pairs(
        n, 65536, np.random.default_rng(11)).tobytes()


@pytest.mark.cuda
def test_bench_rung_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b = _bench()
    data = benchmark.silesia_like(8 << 20, seed=7).tobytes()  # the fused route
    results = b.bench_rung(data, "silesia_like_8MB", reps=2)
    assert [r.name.split("_")[1] for r in results] == ["decode", "encode", "compress", "decompress"]
    for r in results:
        assert r.gbps > 0 and r.spread[0] <= r.gbps <= r.spread[1] and "," in r.device
    with profiling.trace() as prof:
        huffman_tpu_torch.decompress(huffman_tpu_torch.compress(data))
    assert any(str(e.device_type).endswith("CUDA") for e in prof.key_averages())
