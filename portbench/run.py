"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic and limits
are found by name through ``BENCHMARK.json``. Set-up makes the inputs and
weights from the seed, builds the program's runner and drives one step
(attack) or one batch (eval) of the cell's own shapes through it; then the
window runs epochs (``AttackRunner.train_epoch``) or passes
(``AttackRunner.evaluate``) back to back and ends with the one in which
``--seconds`` runs out. ``--trace 1`` profiles one epoch or pass instead
and reports the per-layer metrics. The window's last epoch or pass is
recorded; once the window has closed and the peak memory is read, the
program's state is freed and those outputs are checked against the plain
reference (:mod:`portbench.check`).

The last line of standard output is the result's JSON; the numbers that
decided ``correct`` are the last lines of standard error. Without a CUDA
device, or with fewer than the cell asks for, it exits with 2 and prints no
result; if JAX or the JAX package was imported, with 3.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "paa_tpu")
CHECKED_STEPS = 3  # the first attack steps of the window's last epoch that the reference follows
# seconds of set-up before the run's own steps, by what was done: marked by main()
SETUP_PARTS: dict = {}


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since this module
    was loaded where ``/proc`` is absent."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def mark(part: str) -> None:
    """Charge the process's age, less the parts marked before, to ``part``."""
    SETUP_PARTS[part] = process_age() - sum(SETUP_PARTS.values())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, configuration,
    traffic, limits, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    applies = lambda m: "workloads" not in m or name in m["workloads"]
    return {
        "entry": entry,
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        "cell": json.loads((HERE / "workloads" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or else the one
    of the quantity it splits, ``metrics/<name up to its first dot>.py``
    (``fe_ms.attack`` and ``fe_ms.eval`` both read ``fe_ms.py``; which cells
    report each is ``BENCHMARK.json``'s to say)."""
    own = root / "portbench" / "metrics" / f"{name}.py"
    return own if own.is_file() else own.with_name(name.split(".")[0] + ".py")


def read_metrics(metrics: list, summary: dict) -> dict:
    """Each metric's reader (:func:`reader_path`) on the summary; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in metrics:
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_").replace("-", "_"),
            reader_path(m["name"]))
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        value = reader.read(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """One run of one cell on ``dev``: set-up, window, check."""

    def __init__(self, cell: dict, seed: int, dev):
        from portbench import check, inputs, system

        self.cell, self.seed, self.dev = cell, seed, dev
        cfg, traffic = cell["config"], cell["traffic"]
        self.mode = traffic["mode"]
        # seconds of each part of set-up: those main() marked, the rest of the
        # process up to here, then each step
        self.setup_parts = dict(SETUP_PARTS)
        self.setup_parts["process"] = process_age() - sum(SETUP_PARTS.values())
        mark = time.perf_counter()

        def part(name):
            nonlocal mark
            self.sync()
            now = time.perf_counter()
            self.setup_parts[name] = now - mark
            mark = now

        self.clips = inputs.clips(seed, 1 if self.mode == "attack" else 2, traffic["clips"],
                                  traffic["samples"], tuple(traffic["words"]),
                                  traffic["audio_std"], dev)
        part("clips")
        weights = inputs.weights(cfg, seed, dev)
        part("weights")
        train, evals = (self.clips, None) if self.mode == "attack" else (None, self.clips)
        self.runner = system.build_runner(cfg, traffic, weights, train, evals, dev)
        del weights
        part("runner")
        self.p = self.runner.init_perturbation(seed)
        self.p0 = self.p.detach().clone()
        part("init_p")
        self.opt = system.init_opt_state(self.runner, self.p) if self.mode == "attack" else None
        system.warm_up(self.runner, self.p, self.opt, self.mode)
        part("warm_up")
        # from here on every step is recorded as the window drives it: the
        # first steps of each epoch, or each checked batch of each pass, the
        # latest kept
        per_pass = -(-traffic["clips"] // traffic["batch_size"])
        if self.mode == "attack":
            self.epoch = 0
            self.records = []
            self.runner.train_step = check.record_train(self.runner.train_step, self.records,
                                                        CHECKED_STEPS, per_pass)
        else:
            self.positions = check.eval_positions(per_pass, cell["cell"]["checked_batches"],
                                                  seed)
            self.records = {}
            self.runner.eval_step = check.record_eval(self.runner.eval_step, self.records,
                                                      self.positions, per_pass)

    def unit(self) -> int:
        """One epoch (attack) or pass (eval); the clips it put through."""
        import numpy as np

        r = self.runner
        if self.mode == "attack":
            rng = np.random.default_rng([self.seed, self.epoch])
            self.p, self.opt, _, _ = r.train_epoch(self.p, self.opt, self.epoch, rng)
            self.epoch += 1
            return len(r.pipe.train)
        r.evaluate(r.pipe.eval, self.p, perturbed=True)
        return len(r.pipe.eval)

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        self.sync()
        t0 = time.perf_counter()
        clips, ends = 0, []
        while True:
            clips += self.unit()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        self.sync()
        window_s = time.perf_counter() - t0
        # each epoch's or pass's seconds, as the host saw them end
        unit_s = [b - a for a, b in zip([0.0] + ends[:-1], ends[:-1] + [window_s])]
        return {"window_s": window_s, "clips": clips, "units": len(ends), "unit_s": unit_s}

    def traced(self) -> dict:
        """One epoch or pass under the profiler, profiled again once if the
        trace holds no device operation: the benchmark's scopes (labelled
        as the configuration's family says) and the program's spans."""
        from portbench import family, spans, trace

        fam = family.program(self.cell["config"])
        for _ in range(2):
            with trace.scopes(self.runner, fam):
                events, clips = trace.profile(self.unit)
            summary = trace.summarize(events, trace.labels(fam))
            if summary["device_ops"] > 0:
                summary.update(spans.summarize(events), clips=clips, units=1)
                return summary
        raise RuntimeError("the profiler's trace holds no device operation, twice")

    def free(self) -> None:
        import torch

        self.runner = None
        self.opt = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False) -> dict:
        """The numbers that decide ``correct``; with ``control``, those of
        the control put in the program's place."""
        from portbench import check

        cfg, traffic, cell = self.cell["config"], self.cell["traffic"], self.cell["cell"]
        args = (self.clips, cfg, traffic, self.seed, self.dev, cell["ref_rows"])
        records = self.records
        if self.mode == "eval":
            records = [records[b] for b in self.positions]
        if control:
            records = check.control_records(records, *args)
        if self.mode == "attack":
            return check.attack_numbers(records, self.p0, *args)
        return check.eval_numbers(records, *args)


def execute(cell: dict, seed: int, seconds: float, traced: bool, dev) -> dict:
    """Everything after the look for a chip: set-up, the window (or the
    traced epoch), the peak, the check; the result without its device."""
    import torch

    from portbench import check, counts, family

    run = Run(cell, seed, dev)
    run.sync()
    setup_s = process_age()
    traffic, cfg = cell["traffic"], cell["config"]
    if traced:
        summary = run.traced()
        bound_s = family.program(cfg).bounds(cfg, traffic, run.mode)
        summary.update(
            batches=summary["units"] * -(-traffic["clips"] // traffic["batch_size"]),
            batch_flops=counts.batch_flops(cfg, traffic["batch_size"], traffic["samples"],
                                           run.mode),
            bound_s=bound_s, attention_bound_s=bound_s["attention"])
    else:
        summary = run.window(seconds)
    summary.update(mode=run.mode, setup_s=setup_s,
                   clip_seconds=traffic["samples"] / traffic["sample_rate"],
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    run.free()
    correct, table = check.verdict(run.numbers(), cell["cell"]["limits"])
    result = {"correct": correct, "attempted": summary["clips"], "failed": 0,
              "setup_parts": run.setup_parts, "unit_s": summary.get("unit_s")}
    if traced:
        result.update(metrics=read_metrics(cell["per_layer"], summary),
                      breakdown=summary["breakdown"])
    else:
        result["metrics"] = read_metrics(cell["end_to_end"], summary)
    return {"result": result, "checks": table, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    mark("python")

    import torch

    mark("torch")
    chips = cell["entry"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    mark("cuda")
    from portbench import system

    dev = system.device()
    mark("program")
    out = execute(cell, args.seed % 2**63, args.seconds, bool(args.trace), dev)
    imported = forbidden_modules()
    if imported:
        print(f"portbench: the run imported {imported}", file=sys.stderr)
        return 3
    summary, result = out["summary"], out["result"]
    breakdown = result.pop("breakdown", None)
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                        "count": chips, "memory_peak_bytes": summary["peak_bytes"]}
    if args.trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = breakdown
    result["checks"] = out["checks"]  # last, as the numbers compared
    print(json.dumps(result), flush=True)
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
