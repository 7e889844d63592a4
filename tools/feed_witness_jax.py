"""The JAX package's two data feeds on snr and tv, on the CPU.

    python3 tools/feed_witness_jax.py [--out DIR] [--epochs N]

Runs ``python -m paa_tpu.cli.sweep --platform cpu`` twice under the flags
of ``benchmarks/quality_r5/README.md`` "Optimizer axis" (the committed tiny
checkpoint on 2048 synthetic clips, seed 5, Adam at lr 1e-4, B=32, 12
epochs a cell, early stopping 4), float32, over one cell each of snr 50 and
tv 1e-3: once with the host feed (the default on the CPU), once with
``--device_cache`` (the device corpus, the feed of the round-5 record).
Both norms size their ball from the clean batch, padding rows included,
and the two feeds pad a short batch differently (host: zero rows; device
corpus: copies of row 0). Prints one JSON line per feed and cell with its
best epoch and test scores; the port's sweep, whose feed is a host feed,
is run beside the record by ``tools/quality_sweep_torch.py``. About ten
minutes on a few CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = {"snr": [50.0], "tv": [0.001]}
SCORES = ("best_epoch", "test_clean_ctc", "test_clean_wer", "test_pert_ctc", "test_pert_wer")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "feed_witness"))
    ap.add_argument("--epochs", type=int, default=12)
    args = ap.parse_args()
    for feed, flags in (("host", []), ("device_corpus", ["--device_cache"])):
        out = os.path.join(args.out, feed)
        cmd = [sys.executable, "-m", "paa_tpu.cli.sweep", "--platform", "cpu",
               "--model", "wav2vec2-tiny", "--compute_dtype", "float32",
               "--checkpoint_path",
               os.path.join(ROOT, "checkpoints", "wav2vec2-tiny-synthetic.safetensors"),
               "--dataset", "synthetic", "--synthetic_samples", "2048", "--seed", "5",
               "--optimizer_type", "adam", "--lr", "1e-4", "--batch_size", "32",
               "--epochs_per_cell", str(args.epochs), "--early_stopping", "4",
               "--norms", ",".join(GRID), "--grid", json.dumps(GRID),
               "--num_items_to_inspect", "0", "--save_root", out, "--no_resume", *flags]
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        with open(os.path.join(out, "sweep_results.json")) as f:
            summary = json.load(f)
        for norm in GRID:
            cell = summary[norm]["cells"][0]
            print(json.dumps({"feed": feed, "norm": norm, "size": cell["size"],
                              **{k: cell[k] for k in SCORES}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
