"""Process-level grid launcher — one OS process per (norm × ε) cell.

The reference's sweep script is a PROCESS launcher: ``submit_scan_range.
py`` writes one sbatch script per grid cell (``generate_sbatch_job``,
submit_scan_range.py:8-72), interleaves norms round-robin so early
results cover every norm (:98-117), submits each as an independent
SLURM job with ``--requeue`` (:58), and records the job ids (:120-133).
Each job is a full ``run_attack`` that resumes from its run dir after
preemption (build.py:266-286).

``cli/sweep.py`` runs that grid in one process. This module is the
faithful process-level twin for when OS isolation is what you want (the
port's copy of ``paa_tpu/cli/launch_grid.py``, launching the port's
``run_attack``):

  * a crashed/OOM-killed cell cannot take the rest of the grid down;
  * failed cells are REQUEUED up to ``--retries`` times (the SLURM
    ``--requeue`` semantic), and every attempt resumes from the cell's
    run-dir checkpoint via run_attack's standard resume discovery;
  * cells run ``--max_concurrent`` at a time (default 1 — one card;
    raise it for CPU grids or multi-GPU hosts);
  * every unrecognized flag is passed through to ``run_attack``
    verbatim, exactly like the sbatch scripts' flag assembly
    (submit_scan_range.py:31-49);
  * ``grid_jobs.json`` at the save root records each cell's command,
    attempts, and exit codes (the job-id record, :120-133), and each
    attempt's console output lands in ``grid_logs/``.

Usage::

    python -m paa_tpu_torch.cli.launch_grid --norms max_phon,l2 \
        --save_root logs -- --dataset synthetic --num_epochs 8

(the ``--`` is optional; any flag this module doesn't own is forwarded.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from paa_tpu_torch.cli.sweep import DEFAULT_GRIDS
from paa_tpu_torch.config import SWEEP_ARG


def build_cells(norms: list[str], grids: dict) -> list[tuple[str, float]]:
    """Round-robin interleave the per-norm grids so the first cells of
    the queue cover every norm (reference: submit_scan_range.py:98-117)."""
    cells = []
    for i in range(max((len(grids[n]) for n in norms), default=0)):
        for n in norms:
            if i < len(grids[n]):
                cells.append((n, float(grids[n][i])))
    return cells


def cell_command(python: str, norm: str, size: float, save_root: str,
                 passthrough: list[str]) -> list[str]:
    return [
        python, "-m", "paa_tpu_torch.cli.run_attack",
        "--norm_type", norm,
        f"--{SWEEP_ARG[norm]}", repr(size),
        "--save_root", save_root,
        *passthrough,
    ]


def create_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="All other flags are forwarded to paa_tpu_torch.cli.run_attack "
               "verbatim (one process per grid cell).",
    )
    ap.add_argument("--norms", type=str, default=",".join(DEFAULT_GRIDS),
                    help="comma-separated norm types to grid over")
    ap.add_argument("--grid", type=str, default=None,
                    help="JSON dict {norm_type: [sizes...]} overriding the "
                         "default per-norm grids (submit_scan_range.py:80-88)")
    ap.add_argument("--save_root", type=str, default=None,
                    help="root for per-cell run dirs (default ./logs)")
    ap.add_argument("--max_concurrent", type=int, default=1,
                    help="cells running at once (keep 1 on one card; "
                         "raise for CPU grids)")
    ap.add_argument("--retries", type=int, default=1,
                    help="requeue a failed cell this many times; each "
                         "retry resumes from the cell's checkpoint "
                         "(SLURM --requeue, submit_scan_range.py:58)")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the per-cell commands without launching "
                         "(the generate-scripts half of the reference's launcher)")
    ap.add_argument("--python", type=str, default=sys.executable)
    return ap


def _write_record(path: str, record: list[dict]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2)
    os.replace(tmp, path)


def run_grid(args, passthrough: list[str]) -> int:
    norms = [n.strip() for n in args.norms.split(",") if n.strip()]
    grids = dict(DEFAULT_GRIDS)
    if args.grid:
        grids.update({k: list(v) for k, v in json.loads(args.grid).items()})
    unknown = [n for n in norms if n not in grids]
    if unknown:
        raise SystemExit(f"no grid for norm(s) {unknown}; pass --grid")
    # --grid can introduce norms DEFAULT_GRIDS never had; unless they map
    # to a size flag the cell command below can't be built (reference:
    # submit_scan_range.py:21-29 has the same norm→flag table)
    unmapped = [n for n in norms if n not in SWEEP_ARG]
    if unmapped:
        raise SystemExit(
            f"unknown norm(s) {unmapped}; expected one of {sorted(SWEEP_ARG)}"
        )
    root = args.save_root or os.path.join(os.getcwd(), "logs")
    cells = build_cells(norms, grids)

    if args.dry_run:
        for norm, size in cells:
            print(" ".join(cell_command(
                args.python, norm, size, root, passthrough)))
        return 0

    os.makedirs(root, exist_ok=True)
    log_dir = os.path.join(root, "grid_logs")
    os.makedirs(log_dir, exist_ok=True)
    record_path = os.path.join(root, "grid_jobs.json")
    record = [
        {"norm": n, "size": s, "attempts": 0, "returncodes": [],
         "cmd": " ".join(cell_command(args.python, n, s, root, passthrough))}
        for n, s in cells
    ]
    _write_record(record_path, record)

    # queue of record indices; failed cells re-enter at the BACK (the
    # requeue semantic: other cells get their turn first)
    queue = list(range(len(cells)))
    running: list[tuple[subprocess.Popen, int]] = []  # (proc, record idx)

    def _launch(idx: int) -> None:
        norm, size = cells[idx]
        attempt = record[idx]["attempts"]
        out = open(os.path.join(
            log_dir, f"{norm}_{size}_attempt{attempt}.log"), "w")
        proc = subprocess.Popen(
            cell_command(args.python, norm, size, root, passthrough),
            stdout=out, stderr=subprocess.STDOUT,
        )
        record[idx]["attempts"] += 1
        running.append((proc, idx))

    while queue or running:
        while queue and len(running) < max(1, args.max_concurrent):
            _launch(queue.pop(0))
        time.sleep(0.2)
        for proc, idx in list(running):
            rc = proc.poll()
            if rc is None:
                continue
            running.remove((proc, idx))
            record[idx]["returncodes"].append(rc)
            _write_record(record_path, record)
            norm, size = cells[idx]
            if rc != 0 and record[idx]["attempts"] <= args.retries:
                print(f"cell {norm}={size} failed (rc={rc}); requeueing "
                      f"(attempt {record[idx]['attempts'] + 1})",
                      file=sys.stderr)
                queue.append(idx)
            else:
                state = "done" if rc == 0 else f"FAILED rc={rc}"
                print(f"cell {norm}={size}: {state} "
                      f"({record[idx]['attempts']} attempt(s))",
                      file=sys.stderr)

    failed = [r for r in record if not r["returncodes"]
              or r["returncodes"][-1] != 0]
    print(f"grid: {len(record) - len(failed)}/{len(record)} cells succeeded "
          f"(record: {record_path})", file=sys.stderr)
    return 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    args, passthrough = create_parser().parse_known_args(argv)
    # tolerate an explicit `--` separator before the forwarded flags
    if passthrough and passthrough[0] == "--":
        passthrough = passthrough[1:]
    return run_grid(args, passthrough)


if __name__ == "__main__":
    raise SystemExit(main())
