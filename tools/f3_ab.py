"""Both packages' run_attack on snr and tv from one initial p, float32 on the CPU.

    python3 tools/f3_ab.py [--out DIR] [--epochs N] [--samples N] [--norms snr,tv]

Separates the port's own behaviour from the two known differences between
its sweep on the card and the JAX witness (``tools/feed_witness_jax.py``):
the initial p (torch's RNG against ``jax.random``) and bf16 against float32.

For each cell (snr 50, tv 1e-3) it writes ``p0_<norm>.npy``: the JAX
package's own initial perturbation, ``AttackRunner.init_perturbation`` (the
``jax.random`` draw with the run seed, projected once against the first
train batch), built under the flags below. Then it runs
``python -m paa_tpu.cli.run_attack`` and ``python -m
paa_tpu_torch.cli.run_attack`` with ``--platform cpu --compute_dtype float32
--device_cache --resume_from p0_<norm>.npy`` under the flags of
``benchmarks/quality_r5/README.md`` "Optimizer axis" (the committed tiny
checkpoint on 2048 synthetic clips, seed 5, Adam at lr 1e-4, B=32, 12
epochs, early stopping 4), and prints one JSON line per cell with both
runs' best epoch and test scores, the largest epoch-wise difference of
each ``metrics.jsonl`` series, and the first value where the runs part by
more than 1e-4 of it. The JAX package is only run, never edited;
this tool imports it, the port never does. About fifteen minutes on a few
CPU cores.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"snr": ("--snr_db", "50"), "tv": ("--tv_epsilon", "0.001")}
SERIES = ("train_ctc", "train_wer", "eval_clean_ctc", "eval_clean_wer",
          "eval_pert_ctc", "eval_pert_wer")


def flags(args, norm: str) -> list[str]:
    return ["--platform", "cpu", "--model", "wav2vec2-tiny", "--compute_dtype", "float32",
            "--checkpoint_path",
            os.path.join(ROOT, "checkpoints", "wav2vec2-tiny-synthetic.safetensors"),
            "--dataset", "synthetic", "--synthetic_samples", str(args.samples), "--seed", "5",
            "--optimizer_type", "adam", "--lr", "1e-4", "--batch_size", "32",
            "--num_epochs", str(args.epochs), "--early_stopping", "4",
            "--norm_type", norm, *CELLS[norm], "--num_items_to_inspect", "0",
            "--device_cache", "--no_resume"]


def write_p0(args, norm: str, path: str) -> None:
    """The JAX runner's initial p for this cell (run in this process)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from paa_tpu.cli import parser as parser_lib
    from paa_tpu.cli.run_attack import load_model_bundle
    from paa_tpu.data import datasets, pipeline as pipeline_lib
    from paa_tpu.train import loop

    a = parser_lib.create_arg_parser().parse_args(flags(args, norm))
    cfg = parser_lib.config_from_args(a)
    samples = datasets.load_dataset_tuples(a.dataset, seed=a.seed,
                                           synthetic_samples=a.synthetic_samples)
    pipe = pipeline_lib.build_pipeline(samples, relative_audio_length=a.relative_audio_length,
                                       seed=a.seed, target_sr=a.sr)
    _, params, apply_fn = load_model_bundle(a)
    runner = loop.AttackRunner(cfg, apply_fn, params, pipe,
                               parser_lib.constraint_params_from_args(a))
    import numpy as np

    np.save(path, np.asarray(runner.init_perturbation(cfg.seed), np.float32))


def run(pkg: str, args, norm: str, p0: str, root: str) -> dict:
    cmd = [sys.executable, "-m", f"{pkg}.cli.run_attack", *flags(args, norm),
           "--resume_from", p0, "--save_root", root]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    if proc.returncode:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"{pkg} run_attack on {norm} exited {proc.returncode}")
    (res,) = glob.glob(os.path.join(root, "**", "results.json"), recursive=True)
    with open(res) as f:
        results = json.load(f)
    with open(os.path.join(os.path.dirname(res), "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f if line.strip()]
    scores = {"best_epoch": results["best_epoch"]}
    for split, key in (("clean", "final_test_clean"), ("pert", "final_test_perturbed")):
        scores.update({f"test_{split}_{m}": results[key][m] for m in ("ctc", "wer")})
    return {"scores": scores, "metrics": metrics}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "f3_ab"))
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--norms", default="snr,tv")
    ap.add_argument("--p0_only", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--norm", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.p0_only:  # the JAX draw, in a process of its own
        write_p0(args, args.norm, os.path.join(args.out, f"p0_{args.norm}.npy"))
        return 0
    os.makedirs(args.out, exist_ok=True)
    for norm in args.norms.split(","):
        p0 = os.path.join(args.out, f"p0_{norm}.npy")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--p0_only", "--norm", norm,
                        "--out", args.out, "--samples", str(args.samples)],
                       cwd=ROOT, check=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
        got = {pkg: run(pkg, args, norm, p0, os.path.join(args.out, f"{pkg}_{norm}"))
               for pkg in ("paa_tpu", "paa_tpu_torch")}
        jx, pt = got["paa_tpu"], got["paa_tpu_torch"]
        diff = {}
        for key in SERIES:
            pairs = [(a[key], b[key]) for a, b in zip(jx["metrics"], pt["metrics"])
                     if key in a and key in b]
            diff[key] = max((abs(a - b) for a, b in pairs), default=None)
        # the first epoch's value where the runs part by more than 1e-4 of it
        first = next(({"epoch": a.get("epoch"), "key": k, "jax": a[k], "port": b[k]}
                      for a, b in zip(jx["metrics"], pt["metrics"]) for k in SERIES
                      if k in a and k in b and abs(a[k] - b[k]) > 1e-4 * max(abs(a[k]), 1.0)),
                     None)
        print(json.dumps({
            "norm": norm, "size": CELLS[norm][1],
            "jax": jx["scores"], "port": pt["scores"],
            "test_pert_wer_diff": abs(jx["scores"]["test_pert_wer"]
                                      - pt["scores"]["test_pert_wer"]),
            "epochs": [len(jx["metrics"]), len(pt["metrics"])],
            "max_series_diff": diff, "first_parting": first}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
