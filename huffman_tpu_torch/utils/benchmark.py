"""Benchmark data and the result record: counterpart of
huffman_tpu/utils/benchmark.py.

The corpora are the port's copies in ``huffman_tpu_torch/corpus.py``
(re-exported here under the JAX module's names); the bench itself is
``bench_torch.py`` at the repository root, timed with ``utils/timing.py``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
from dataclasses import dataclass

import torch

from ..corpus import silesia_like, zipf_pairs

__all__ = ["BenchResult", "device_line", "silesia_like", "zipf_pairs"]


def device_line(device: torch.device | str) -> str:
    """The device a number was taken on: for a CUDA device, its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (a card below its maximum limit runs
    slower under load); else the device's type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    r = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


@dataclass
class BenchResult:
    """One measured metric: the median ``seconds`` of a call over ``reps``
    repetitions, its rate ``gbps`` (input bytes over the median), the
    ``spread`` of the rate over the repetitions (slowest, fastest) and the
    ``device`` line it was taken on."""

    name: str
    seconds: float
    gbps: float
    device: str = ""
    spread: tuple[float, float] = (0.0, 0.0)
    reps: int = 1

    @classmethod
    def from_times(cls, name: str, n_bytes: int, times: list[float], device: str) -> "BenchResult":
        median = statistics.median(times)
        return cls(name, median, n_bytes / median / 1e9, device,
                   (n_bytes / max(times) / 1e9, n_bytes / min(times) / 1e9), len(times))

    def json_line(self) -> str:
        return json.dumps({
            "metric": self.name, "value": self.gbps, "unit": "GB/s",
            "spread": list(self.spread), "reps": self.reps, "device": self.device,
        })

    def __str__(self) -> str:
        return (f"{self.name}: {self.seconds * 1000:.2f} ms, {self.gbps:.2f} GB/s "
                f"({self.spread[0]:.2f}-{self.spread[1]:.2f} over {self.reps}; {self.device})")
