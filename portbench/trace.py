"""The traced run: the benchmark's own scopes, one profiled epoch or pass,
and the reduction of its trace to a summary the per-layer readers use.

Scopes are ``record_function`` ranges opened from these files, never from
the program's source:

* the model's layers: opened by forward pre-hooks and closed by forward
  hooks on the model's modules, found by class name and labelled as the
  configuration's family says (``families/<family>.py``'s ``SCOPES``;
  wav2vec2's ``fe``, ``pos_conv`` and ``encoder``);
* ``attention``: around the model's call into the attention kernels (the
  attribute ``attention`` of each module in the family's
  ``ATTENTION_MODULES``);
* host scopes for naming idle gaps: ``attack.step`` and ``attack.eval_step``
  around the runner's step functions, ``loop.scoring`` around the loop's
  host scoring (``paa_tpu_torch.train.loop._scores``).

A device operation (kernel, copy or fill) is charged to the innermost
scope around its launch, found through its correlation id; one launched by
an autograd node of the backward is charged to the innermost scope of the
forward operation that made the node, linked by sequence number, or to a
scope opened inside the node (a recompute under remat). Where operations
overlap in time, each instant is charged once, to the one that started
first, so that the scopes add up to the device's busy time
(``portbench.spans.charge``, the one rule for the scopes and the program's
own spans).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import json
import os
import tempfile

import torch

ATTENTION = "attention"
STEP_SCOPES = {"train_step": "attack.step", "eval_step": "attack.eval_step"}
SCORING = "loop.scoring"
WINDOW = "portbench.window"
HARNESS_LABELS = frozenset([ATTENTION, *STEP_SCOPES.values(), SCORING])
OUTSIDE = "outside"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ranged(fn, label: str):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def labels(family) -> frozenset:
    """Every scope's label: the family's model scopes (``family`` is its
    ``families/<family>.py``) and the harness's own (attention, the steps
    and the scoring)."""
    return HARNESS_LABELS | frozenset(family.SCOPES.values())


@contextlib.contextmanager
def scopes(runner, family):
    """Open the benchmark's scopes on ``runner``'s model, steps and loop
    for the duration of the block; the model's as ``family`` (its
    ``families/<family>.py``) lays them out."""
    from paa_tpu_torch.train import loop as program_loop

    handles, open_ranges = [], []

    def enter(label):
        def pre(_module, _args):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            open_ranges.append(rf)
        return pre

    def leave(_module, _args, _out):
        open_ranges.pop().__exit__(None, None, None)

    for module in runner.model.modules():
        label = family.SCOPES.get(type(module).__name__)
        if label is not None:
            handles.append(module.register_forward_pre_hook(enter(label)))
            handles.append(module.register_forward_hook(leave))
    models = [importlib.import_module(m) for m in family.ATTENTION_MODULES]
    saved_attention = [m.attention for m in models]
    saved_scores = program_loop._scores
    saved_steps = {name: getattr(runner, name) for name in STEP_SCOPES}
    for m, fn in zip(models, saved_attention):
        m.attention = _ranged(fn, ATTENTION)
    program_loop._scores = _ranged(saved_scores, SCORING)
    for name, label in STEP_SCOPES.items():
        setattr(runner, name, _ranged(saved_steps[name], label))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for m, fn in zip(models, saved_attention):
            m.attention = fn
        program_loop._scores = saved_scores
        for name, fn in saved_steps.items():
            setattr(runner, name, fn)


def profile(fn) -> tuple[list, object]:
    """Run ``fn`` inside the window scope under ``torch.profiler`` (CPU and
    CUDA) and return the trace's events and ``fn``'s result. The trace is
    written under ``TMPDIR`` and deleted once read."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"], out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _chains(events: list) -> tuple[dict, dict]:
    """(correlation id → the CPU events around its launch, innermost last;
    CPU events by thread, sorted)."""
    cpu = collections.defaultdict(list)
    launches = []
    for e in events:
        cat = e.get("cat")
        if cat in ("cpu_op", "user_annotation"):
            cpu[e["tid"]].append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches.append(e)
    chains = {}
    for evs in cpu.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
    by_tid = collections.defaultdict(list)
    for e in launches:
        by_tid[e["tid"]].append(e)
    for tid, points in by_tid.items():
        evs = cpu.get(tid, [])
        points.sort(key=lambda e: e["ts"])
        stack, i = [], 0
        for pt in points:
            while i < len(evs) and evs[i]["ts"] <= pt["ts"]:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < evs[i]["ts"]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < pt["ts"]:
                stack.pop()
            chains[pt["args"]["correlation"]] = list(stack)
    return chains, cpu


def summarize(events: list, labels: frozenset = HARNESS_LABELS, top: int = 10) -> dict:
    """The traced window's numbers: ``window_s``, ``busy_s`` (the union of
    device operations inside it), ``device_ops`` (count), ``scope_ms``
    (device ms charged to each of ``labels``, or ``outside``, adding up to
    ``busy_s``; by default the harness's own scopes, :func:`labels` adds a
    family's) and ``breakdown``."""
    from portbench import spans

    w = spans.window(events)
    w0, w1 = w["ts"], w["ts"] + w["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device)
    scope_ms = collections.Counter()
    by_name = collections.Counter()
    for label, e, a, b in spans.charge(events, labels.__contains__, w0, w1):
        scope_ms[label] += (b - a) / 1e3
        by_name[e["name"][:120]] += (b - a) / 1e6
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((a - edge, edge, a))
        edge = max(edge, b)
    main = sorted((e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
                   and e["tid"] == w["tid"]), key=lambda e: (e["ts"], -e["dur"]))
    host = _HostClock(main, labels)
    named = collections.Counter()
    for length, a, b in sorted(gaps, reverse=True)[:200]:
        named[host.name((a + b) / 2)] += length / 1e6
    return {
        "window_s": w["dur"] / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": len(device),
        "scope_ms": dict(scope_ms),
        "breakdown": {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
                      "idle_gaps": [[k, v] for k, v in named.most_common(top)]},
    }


class _HostClock:
    """What the main thread was doing at a time: the benchmark's innermost
    scope and the innermost operation."""

    def __init__(self, evs: list, labels: frozenset):
        self.ops = [e for e in evs if e.get("cat") == "cpu_op"]
        self.starts = [e["ts"] for e in self.ops]
        self.scopes = [e for e in evs if e["name"] in labels]

    def name(self, t: float) -> str:
        scope = None
        for e in self.scopes:
            if e["ts"] <= t <= e["ts"] + e["dur"]:
                scope = e["name"]
        op = None
        i = bisect.bisect_right(self.starts, t) - 1
        for e in reversed(self.ops[max(0, i - 500):i + 1]):
            if e["ts"] + e["dur"] >= t:
                op = e["name"]
                break
        parts = [p for p in (scope, op) if p]
        return " > ".join(parts)[:120] if parts else "host, outside any scope"
