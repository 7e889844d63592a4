"""Run one cell several times, one process a run, and report the spread.

    python3 portbench/repeat.py --workload <cell> --seeds 101-106 [--seconds S] \
        [--trace 0|1] [--out DIR]

Each run is ``python3 portbench/run.py`` with one seed of the list, in
order. Every result line, with the run's exit code, wall time and the end
of its standard error, is appended to ``DIR/runs.<cell>.jsonl`` (default
``portbench_runs``); then each metric's median and spread (the distance
between the first and the third quartile of ``statistics.quantiles(n=4)``
over the median) is printed, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.calibrate import seeds  # noqa: E402


def spread(values: list) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="portbench_runs")
    args = ap.parse_args()
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"runs.{args.workload}.jsonl"
    values = {}
    info = card()
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": seed, "seconds": seconds,
               "trace": args.trace, "rc": proc.returncode,
               "wall_s": time.perf_counter() - t0, "card": info, "result": result,
               "stderr_tail": proc.stderr[-3000:]}
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": row["wall_s"],
                          "correct": (result or {}).get("correct"), "metrics": brief,
                          "checks": {k: v["value"] for k, v in
                                     (result or {}).get("checks", {}).items()}}), flush=True)
        if result is None:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
        for k, v in brief.items():
            values.setdefault(k, []).append(v)
    print(json.dumps({"workload": args.workload, "card": info, "runs": len(seeds(args.seeds)),
                      "median": {k: statistics.median(v) for k, v in values.items()},
                      "spread": {k: spread(v) for k, v in values.items() if len(v) >= 2}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
