"""The JAX package's round-5 optimizer A/B sweep through the port's sweep,
beside the JAX record.

    python3 tools/quality_sweep_torch.py [--platform cpu] [--epochs N] [--samples N]
                                         [--device_cache | --no_device_cache]

Runs ``python -m paa_tpu_torch.cli.sweep`` with the flags of
``benchmarks/quality_r5/README.md`` "Optimizer axis" (the committed tiny
checkpoint on 2048 synthetic clips, seed 5, Adam at lr 1e-4, B=32, 12 epochs
a cell, early stopping 4; one cell each of snr 50, linf 1.5e-3,
fletcher_munson 8.9, l2 0.1 and tv 1e-3) into ``chiprun_out/quality_sweep/``,
and prints one JSON line per cell with the port's and the JAX record's
(``benchmarks/quality_r5/cells/adam_ab_sweep_results.json``) best epoch and
test scores, then one line with the sweep's wall time and cell steps/s and
the device. The port draws its initial perturbation from torch's RNG, the
JAX package from ``jax.random``, so the two agree in level, not bit for bit.
Without ``--platform cpu`` it runs on the GPU and fails without one.
``--device_cache`` and ``--no_device_cache`` pass through to the sweep
(default: its auto, the device feed on the GPU and the host feed on the
CPU); the last line names the feed that ran, as the sweep's log states it.
The JAX record ran on its device corpus, whose padding rows snr and tv read.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "benchmarks", "quality_r5", "cells", "adam_ab_sweep_results.json")
GRID = {"snr": [50.0], "linf": [0.0015], "fletcher_munson": [8.9], "l2": [0.1], "tv": [0.001]}
SCORES = ("best_epoch", "test_clean_ctc", "test_clean_wer", "test_pert_ctc", "test_pert_wer")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "quality_sweep"))
    feed = ap.add_mutually_exclusive_group()
    feed.add_argument("--device_cache", action="store_true")
    feed.add_argument("--no_device_cache", action="store_true")
    args = ap.parse_args()
    if args.platform == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("quality_sweep_torch.py: no CUDA device (pass --platform cpu)", file=sys.stderr)
            return 1
        device = torch.cuda.get_device_name(0)
    else:
        device = "cpu"
    cmd = [sys.executable, "-m", "paa_tpu_torch.cli.sweep", "--platform", args.platform,
           "--model", "wav2vec2-tiny",
           "--checkpoint_path", os.path.join(ROOT, "checkpoints", "wav2vec2-tiny-synthetic.safetensors"),
           "--dataset", "synthetic", "--synthetic_samples", str(args.samples), "--seed", "5",
           "--optimizer_type", "adam", "--lr", "1e-4", "--batch_size", "32",
           "--epochs_per_cell", str(args.epochs), "--early_stopping", "4",
           "--norms", ",".join(GRID), "--grid", json.dumps(GRID), "--num_items_to_inspect", "0",
           "--save_root", args.out, "--no_resume"]
    cmd += ["--device_cache"] if args.device_cache else []
    cmd += ["--no_device_cache"] if args.no_device_cache else []
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if run.returncode:
        print(run.stderr[-4000:], file=sys.stderr)
        return run.returncode
    with open(os.path.join(args.out, "sweep_results.json")) as f:
        port = json.load(f)
    with open(RECORD) as f:
        record = json.load(f)
    for norm in GRID:
        got, want = port[norm]["cells"][0], record[norm]["cells"][0]
        print(json.dumps({"norm": norm, "size": got["size"],
                          "port": {k: got[k] for k in SCORES},
                          "jax_record": {k: want[k] for k in SCORES},
                          "port_cell_steps_per_sec": port[norm]["cell_steps_per_sec"],
                          "port_n_cell_steps": port[norm]["n_cell_steps"],
                          "jax_n_cell_steps": record[norm]["n_cell_steps"]}))
    with open(os.path.join(args.out, "sweep.log")) as f:
        log = f.read()
    feed = ("device" if "staged split to device" in log else
            "cached" if "caching the first" in log else "host")
    print(json.dumps({"wall_s": wall, "device": device, "epochs": args.epochs,
                      "samples": args.samples, "feed": feed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
