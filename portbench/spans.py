"""The program's own spans in a traced epoch or pass, and the charge rule
that ``trace.py`` applies to the benchmark's scopes, with its labels given
by a predicate.

    python3 portbench/spans.py --workload <cell> --seed <n>

From the root of a checkout, on the card: the cell's set-up as ``run.py``
makes it, then one epoch or pass traced as ``run.py --trace 1`` traces it.
It prints one JSON line: the card, the traced summary's numbers (the
scopes' and :func:`summarize`'s, which the traced summary carries), and per
batch the quantities read from the spans beside the benchmark's scopes of
the same layers. It checks nothing against the reference.

The program (``paa_tpu_torch/spans.py``) opens ``record_function`` ranges
named ``paa.*`` while a profiler runs. :func:`summarize` reduces a trace to

* ``span_ms``: device ms by innermost span, by :func:`charge`'s rule with
  the ``paa.*`` names as labels; with ``outside`` they add up to the busy
  time;
* ``span_host_ms``: host ms by span on the window's thread, each span's
  duration less the part its ``paa.*`` children cover;
* ``span_idle_ms``: ms of the window in which no device operation ran while
  the span was the innermost ``paa.*`` span open on that thread.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402

PREFIX = "paa."


def is_span(name: str) -> bool:
    return name.startswith(PREFIX)


def window(events: list) -> dict:
    """The longest window scope of the trace."""
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == trace.WINDOW]
    if not windows:
        raise RuntimeError("the trace has no window scope")
    return max(windows, key=lambda e: e["dur"])


def _forward_scopes(cpu: dict, is_label) -> dict:
    """Sequence number → innermost label of the forward operation that made
    that autograd node (``trace._forward_scopes`` with ``is_label``)."""
    fwd = {}
    for evs in cpu.values():
        if not any(is_label(e["name"]) for e in evs):
            continue
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            seq = e.get("args", {}).get("Sequence number")
            if (seq is not None and "evaluate_function" not in e["name"]
                    and not any("evaluate_function" in s["name"] for s in stack)):
                fwd[seq] = next((s["name"] for s in reversed(stack) if is_label(s["name"])),
                                trace.OUTSIDE)
            stack.append(e)
    return fwd


def charge(events: list, is_label, w0: float, w1: float):
    """Each stretch of device time in ``[w0, w1]`` (µs) with the label it is
    charged to: ``(label, operation, start, end)``. An operation goes to the
    innermost label around its launch; a backward one to the innermost label
    of the forward operation that made its autograd node, or to a label
    opened inside the node (a recompute under remat). Where operations
    overlap, each instant goes to the one that started first."""
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    chains, cpu = trace._chains(events)
    fwd = _forward_scopes(cpu, is_label)

    def label(chain) -> str:
        for e in reversed(chain):
            if is_label(e["name"]):
                return e["name"]
            if "evaluate_function" in e["name"]:
                return fwd.get(e.get("args", {}).get("Sequence number"), trace.OUTSIDE)
        return trace.OUTSIDE

    # each instant of device activity is charged once, to the operation that
    # started first among those running: Hopper's library kernels launch
    # early and overlap their predecessor, so their durations sum to more
    # than the busy time
    edge = w0
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], edge), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        edge = b
        yield label(chains.get(e.get("args", {}).get("correlation"), [])), e, a, b


def _innermost(evs: list, w0: float, w1: float) -> list:
    """``(start, end, name)`` stretches of ``[w0, w1]`` in which each span of
    ``evs`` (one thread's, nested) was the innermost one open, in order."""
    out, stack = [], []  # stack: [span, the start of its current stretch]
    inner = sorted((e for e in evs if w0 <= e["ts"] and e["ts"] + e["dur"] <= w1),
                   key=lambda e: (e["ts"], -e["dur"]))

    def close_until(t):
        while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= t:
            e, start = stack.pop()
            end = e["ts"] + e["dur"]
            out.append((start, end, e["name"]))
            if stack:
                stack[-1][1] = end

    for e in inner:
        close_until(e["ts"])
        if stack:
            out.append((stack[-1][1], e["ts"], stack[-1][0]["name"]))
        stack.append([e, e["ts"]])
    close_until(float("inf"))
    return [s for s in out if s[1] > s[0]]


def summarize(events: list) -> dict:
    """``span_ms``, ``span_host_ms`` and ``span_idle_ms`` of the trace's
    window (module docstring)."""
    w = window(events)
    w0, w1 = w["ts"], w["ts"] + w["dur"]
    span_ms = collections.Counter()
    busy = []
    for name, _e, a, b in charge(events, is_span, w0, w1):
        span_ms[name] += (b - a) / 1e3
        busy.append((a, b))
    busy = trace._merge(busy)
    gaps, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    main = [e for e in events if e.get("cat") == "user_annotation" and e["tid"] == w["tid"]
            and is_span(e["name"])]
    host_ms, idle_ms = collections.Counter(), collections.Counter()
    i = 0
    for a, b, name in _innermost(main, w0, w1):
        host_ms[name] += (b - a) / 1e3
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            idle_ms[name] += (min(b, gaps[j][1]) - max(a, gaps[j][0])) / 1e3
            j += 1
    return {"span_ms": dict(span_ms), "span_host_ms": dict(host_ms), "span_idle_ms": dict(idle_ms)}


# the benchmark's scope of the layer each model span covers
HOOKED = {"paa.fe": "fe", "paa.pos_conv": "pos_conv", "paa.encoder": "encoder",
          "paa.attention": "attention"}


def per_batch(spans: dict, batches: int) -> dict:
    """The quantities a batch: device ms of the feed, CTC (forward and
    backward) and update; the host's scoring less its waits on the device;
    the device's idle time while scoring or waiting."""
    device, host, idle = spans["span_ms"], spans["span_host_ms"], spans["span_idle_ms"]
    out = {f"{k}_ms": device[f"paa.{k}"] / batches for k in ("feed", "ctc", "update")
           if f"paa.{k}" in device}
    if "paa.score" in host:
        out["scoring_host_ms"] = host["paa.score"] / batches
        out["scoring_idle_ms"] = (idle.get("paa.score", 0.0)
                                  + idle.get("paa.score.wait", 0.0)) / batches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import run, system

    if not torch.cuda.is_available():
        print("portbench/spans.py: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    s = run.Run(cell, args.seed % 2**63, system.device()).traced()
    traffic = cell["traffic"]
    batches = -(-traffic["clips"] // traffic["batch_size"])
    scope_ms = s["scope_ms"]
    against = {k: {"span_ms": s["span_ms"].get(k), "scope_ms": scope_ms.get(v),
                   "rel": (s["span_ms"].get(k, 0.0) / scope_ms[v] - 1) if scope_ms.get(v)
                   else None} for k, v in HOOKED.items()}
    spans = {k: s[k] for k in ("span_ms", "span_host_ms", "span_idle_ms")}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": torch.cuda.get_device_name(0), "clips": s["clips"],
                      "batches": batches, "window_s": s["window_s"], "busy_s": s["busy_s"],
                      "scope_ms": scope_ms, **spans, "per_batch": per_batch(spans, batches),
                      "spans_against_scopes": against,
                      "idle_gaps": s["breakdown"]["idle_gaps"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
