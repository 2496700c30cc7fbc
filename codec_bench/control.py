#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference in the
codec's place, with one guarantee of the configuration broken
(``entries/<kind>.py``'s ``control``), through the rest of a run. The check
has to come out false.

    python3 codec_bench/control.py --workload <cell> --seeds <n,n,...> [--seconds S]

One process, one run per seed, each a single pass of the window
(``--seconds`` 0) unless asked for more; prints each run's compared
numbers and its ``correct`` as one JSON line, then a summary line. The
benchmark's own runs never run it. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:] = [str(BENCH.parent)] + [p for p in sys.path if Path(p or ".").resolve() != BENCH]

from codec_bench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.info("control.py needs a CUDA card")
        return 2
    cell = run.resolve(args.workload)
    control = cell.entry.control(cell.direction, cell.config["settings"])
    outcomes = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(), call=control)
        line = {"workload": cell.name, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "checks": r["checks"]}
        print(json.dumps(line), flush=True)
        outcomes.append(r["correct"])
    print(json.dumps({"workload": cell.name, "control_runs": len(outcomes),
                      "control_correct": sum(outcomes)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
