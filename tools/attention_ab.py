"""K1/K2's register route on the card, this checkout against another one.

    python3 tools/attention_ab.py [--against DIR] [--all] [--pretrain] [--out FILE]

Runs ``chip_smoke.py``'s ``check_attention`` (this checkout's: errors
against the plain versions, K2's bits over two calls, call ms, device ms
from a CUDA graph of 100 calls, SDPA's call and device ms, the bound) at
the shapes the main paths give the register route: (32, 152, 4, 16)
float32 (the tiny recipe's pretraining batch) and bf16 (the tiny anchor),
(16, 152, 4, 16) and (32, 152, 2, 16) bf16 (its dp=2 and tp=2 ranks) and
(64, 499, 12, 64) float32 (base under ``--compute_dtype float32``); with
``--all`` also phase 2's test shapes of the route. With ``--against DIR``
(for instance the parent commit unpacked by ``git archive``) the same
checks run on DIR's kernels, built from DIR's sources, in turns: DIR,
this, this, DIR, each in a process of its own. ``--pretrain`` adds
``chip_smoke.py``'s phase 8 for each checkout in the same turns, for the
tiny recipe's wall (phase 8 (b)). Prints one JSON line per check, tagged
with its checkout and turn, into ``--out`` (default
``chiprun_out/attention_ab.jsonl``) and to standard output, the card's
name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = [(32, 152, 4, 16, "float32"), (32, 152, 4, 16, "bfloat16"),
        (16, 152, 4, 16, "bfloat16"), (32, 152, 2, 16, "bfloat16"),
        (64, 499, 12, 64, "float32")]
TESTS = [(2, T, 4, 16, dt) for T in (1, 130, 499) for dt in ("float32", "bfloat16")] + [
    (2, T, 12, 64, "float32") for T in (1, 130, 499, 640)] + [
    (2, T, 16, 64, "float32") for T in (774, 999, 1499)]


def worker(label: str, shapes: list, pretrain: bool) -> int:
    """One turn, run with the checkout under test as the working directory:
    its ``paa_tpu_torch``, this checkout's ``chip_smoke.py``."""
    sys.path.insert(0, os.getcwd())
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert os.path.dirname(cs._lib.__file__).startswith(os.getcwd()), cs._lib.__file__
    cs._lib.library()
    dev = torch.device("cuda")
    for B, T, H, d, dt in shapes:
        r = cs.check_attention(B, T, H, d, getattr(torch, dt), dev,
                               iters=5 if B * T * H * d > 1e6 else 20)
        print(json.dumps({"turn": label, "checkout": os.getcwd(), **r}), flush=True)
    if pretrain:
        cs.phase_pretrain(dev, "")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pretrain", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "attention_ab.jsonl"))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = MAIN + (TESTS if args.all else [])
    if args.worker:
        return worker(args.worker, shapes, args.pretrain)
    import torch

    if not torch.cuda.is_available():
        print("attention_ab.py: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    turns = ([("other", args.against), ("this", ROOT), ("this2", ROOT), ("other2", args.against)]
             if args.against else [("this", ROOT)])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        out.write(json.dumps({"card": card}) + "\n")
        print(json.dumps({"card": card}), flush=True)
        for label, root in turns:
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", label]
            cmd += ["--all"] if args.all else []
            cmd += ["--pretrain"] if args.pretrain else []
            run = subprocess.run(cmd, cwd=os.path.abspath(root), capture_output=True, text=True)
            for line in run.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    if "phase" in rec and rec.get("phase") == "pretrain":
                        if rec.get("run") != "tiny_recipe":
                            continue
                        rec = {"turn": label, "checkout": root, "run": "tiny_recipe",
                               **{k: rec[k] for k in ("wall_sec", "seconds", "steps_run",
                                                      "best_eval_wer", "launches")}}
                    elif "turn" not in rec:
                        continue
                    out.write(json.dumps(rec) + "\n")
                    print(json.dumps(rec), flush=True)
            if run.returncode:
                print(run.stderr[-4000:], file=sys.stderr)
                return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
