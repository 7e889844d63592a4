"""Results aggregator — ``python -m paa_tpu_torch.cli.aggregate [--root logs]``.

Walks every run directory under the logs root, collects ``results.json``
files, and prints the WER/CTC-vs-constraint table the reference's README
leaves blank (README.md:91-100) — implementing the ``data_plots/
grab_results.py`` the reference references but never committed
(SURVEY.md §5.5).
"""

from __future__ import annotations

import argparse
import json
import os


def collect(root: str) -> list[dict]:
    rows = []
    for dirpath, _dirs, files in os.walk(root):
        if "results.json" not in files:
            continue
        try:
            with open(os.path.join(dirpath, "results.json")) as f:
                r = json.load(f)
        except Exception:
            continue
        rel = os.path.relpath(dirpath, root)
        parts = rel.split(os.sep)
        # run dirs are named {norm}_{size}_{mode}_{opt} (cli/run_attack.
        # make_save_dir) — the optimizer only lives in the dir name
        leaf = parts[-1]
        optimizer = leaf.rsplit("_", 1)[-1] if "_" in leaf else "?"
        rows.append(
            {
                "run": rel,
                "attack_mode": parts[0] if len(parts) > 2 else "?",
                "dataset": parts[1] if len(parts) > 2 else "?",
                "optimizer": optimizer,
                "norm_type": r.get("norm_type", "?"),
                "attack_size": r.get("attack_size"),
                "finished": bool(r.get("finished_training", False)),
                "clean_ctc": (r.get("final_test_clean") or r.get("eval_score_clean") or {}).get("ctc"),
                "clean_wer": (r.get("final_test_clean") or r.get("eval_score_clean") or {}).get("wer"),
                "pert_ctc": (r.get("final_test_perturbed") or r.get("eval_score_perturbed") or {}).get("ctc"),
                "pert_wer": (r.get("final_test_perturbed") or r.get("eval_score_perturbed") or {}).get("wer"),
                "efficiency_ctc": (r.get("perturbation_efficiency") or {}).get("ctc")
                if isinstance(r.get("perturbation_efficiency"), dict)
                else r.get("perturbation_efficiency"),
                "steps_per_sec": r.get("steps_per_sec"),
                "error": r.get("error"),
            }
        )
    return rows


def render(rows: list[dict]) -> str:
    fmt = lambda v: ("-" if v is None else (f"{v:.3f}" if isinstance(v, float) else str(v)))
    # sizes span decades (linf 1e-4 vs 3e-4) — fixed .3f collapses both
    # to "0.000"; %g keeps close epsilons distinct
    fmt_size = lambda v: ("-" if v is None else (f"{v:g}" if isinstance(v, float) else str(v)))
    header = (
        f"{'norm':<16} {'size':>9} {'mode':<11} {'dataset':<13} "
        f"{'cleanCTC':>9} {'pertCTC':>9} {'cleanWER':>9} {'pertWER':>9} {'eff':>6} {'done':>5}"
    )
    lines = [header, "-" * len(header)]
    for r in sorted(rows, key=lambda r: (str(r["norm_type"]), r["attack_size"] or 0)):
        lines.append(
            f"{fmt(r['norm_type']):<16} {fmt_size(r['attack_size']):>9} {r['attack_mode']:<11} "
            f"{r['dataset']:<13} {fmt(r['clean_ctc']):>9} {fmt(r['pert_ctc']):>9} "
            f"{fmt(r['clean_wer']):>9} {fmt(r['pert_wer']):>9} "
            f"{fmt(r['efficiency_ctc']):>6} {str(r['finished']):>5}"
        )
    return "\n".join(lines)


def plot(rows: list[dict], out_dir: str) -> list[str]:
    """Constraint-size sweep curves per (norm, mode, dataset): perturbed
    test CTC/WER vs epsilon with the clean baseline as a dashed line —
    the CTC-vs-constraint view behind the paper's Table 1
    (reference: paper/report.pdf p.9; the committed ``data_plots/
    grab_results.py`` that would have drawn it was never shipped).

    matplotlib is an optional extra (pyproject ``[plots]``); without it
    the table/JSON outputs still work and plotting degrades to a notice
    (same policy as train/artifacts.HAVE_MPL)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("aggregate --plot: matplotlib not installed "
              "(pip install 'paa-tpu[plots]'); skipping sweep curves")
        return []

    os.makedirs(out_dir, exist_ok=True)
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        if r["attack_size"] is None or r["pert_ctc"] is None:
            continue
        try:
            float(r["attack_size"])
        except (TypeError, ValueError):
            continue
        # optimizer must split groups: pgd and adam runs of the same
        # norm are different experiments, not one epsilon sweep
        key = (r["norm_type"], r["attack_mode"], r["dataset"], r["optimizer"])
        groups.setdefault(key, []).append(r)
    written = []
    for (norm, mode, dataset, opt), rs in sorted(groups.items()):
        rs = sorted(rs, key=lambda r: float(r["attack_size"]))
        sizes = [float(r["attack_size"]) for r in rs]
        for metric, label in (("ctc", "CTC loss (sum)"), ("wer", "WER")):
            vals = [r[f"pert_{metric}"] for r in rs]
            if any(v is None for v in vals):
                continue
            plt.figure(figsize=(7, 4))
            plt.plot(sizes, vals, marker="o",
                     label=f"perturbed test {metric.upper()}")
            clean = [r[f"clean_{metric}"] for r in rs
                     if r[f"clean_{metric}"] is not None]
            if clean:
                plt.axhline(sum(clean) / len(clean), linestyle="--",
                            color="gray", label=f"clean {metric.upper()}")
            plt.xlabel(f"{norm} constraint size")
            plt.ylabel(label)
            plt.title(f"{norm} sweep — {mode}, {dataset}, {opt}")
            plt.grid(True)
            plt.legend()
            plt.tight_layout()
            path = os.path.join(
                out_dir, f"{norm}_{mode}_{dataset}_{opt}_{metric}.png"
            )
            plt.savefig(path)
            plt.close()
            written.append(path)
    return written


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="logs", help="logs root to walk")
    ap.add_argument("--json", default=None, help="also write aggregate JSON here")
    ap.add_argument("--plot", default=None, metavar="DIR",
                    help="also write per-norm epsilon-sweep curves "
                         "(perturbed CTC/WER vs constraint size) here")
    args = ap.parse_args()
    rows = collect(args.root)
    if not rows:
        print(f"no results.json found under {args.root!r}")
        return 1
    print(render(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    if args.plot:
        for path in plot(rows, args.plot):
            print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
