"""Readings that a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12 \
        [--control 3] [--faults half_batch,altered_token] [--fault_seeds 3] [--out DIR]

For each seed it runs the cell's set-up and one epoch or pass of the
window, and prints the numbers that decide ``correct`` for the
program; on the first ``--control`` seeds also the control's (the
reference in fp8 put in the program's place), and on the first
``--fault_seeds`` seeds the program's under each planted fault
(:mod:`portbench.faults`). One JSON line each, also appended to
``DIR/calibrate.<cell>.jsonl`` (default ``portbench_runs``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import faults  # noqa: E402
from portbench.run import Run, load_cell  # noqa: E402


def seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def reading(cell: dict, seed: int, dev, control: bool, fault: str | None) -> dict:
    import torch

    t0 = time.perf_counter()
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run = Run(cell, seed, dev)
        run.window(0.0)
    setup = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    run.free()
    t1 = time.perf_counter()
    out = {"seed": seed, "side": fault or "program", "setup_s": setup, "peak_bytes": peak,
           "numbers": run.numbers()}
    out["reference_s"] = time.perf_counter() - t1
    if control:
        t2 = time.perf_counter()
        out["control"] = run.numbers(control=True)
        out["control_s"] = time.perf_counter() - t2
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault_seeds", type=int, default=3)
    ap.add_argument("--out", default="portbench_runs")
    args = ap.parse_args()
    import torch

    from portbench import system

    cell = load_cell(args.workload)
    dev = system.device()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"calibrate.{args.workload}.jsonl"
    card = torch.cuda.get_device_name(dev)
    for i, seed in enumerate(seeds(args.seeds)):
        sides = [None] + ([f for f in args.faults.split(",") if f]
                          if i < args.fault_seeds else [])
        for fault in sides:
            line = json.dumps({"workload": args.workload, "card": card,
                               **reading(cell, seed, dev, i < args.control and fault is None,
                                         fault)})
            print(line, flush=True)
            with open(path, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
