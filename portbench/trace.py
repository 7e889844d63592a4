"""The traced run: the benchmark's own scopes, one profiled epoch or pass,
and the reduction of its trace to a summary the per-layer readers use.

Scopes are ``record_function`` ranges opened from these files, never from
the program's source:

* ``fe``, ``pos_conv`` and ``encoder``: opened by forward pre-hooks and
  closed by forward hooks on the model's modules, found by class name
  (``FeatureExtractor``, ``PositionalConvEmbedding``, ``Encoder``);
* ``attention``: around the model's call into the attention kernels (the
  module attribute ``attention`` of ``paa_tpu_torch.models.wav2vec2``);
* host scopes for naming idle gaps: ``attack.step`` and ``attack.eval_step``
  around the runner's step functions, ``loop.scoring`` around the loop's
  host scoring (``paa_tpu_torch.train.loop._scores``).

A device operation (kernel, copy or fill) is charged to the innermost
scope around its launch, found through its correlation id; one launched by
an autograd node of the backward is charged to the innermost scope of the
forward operation that made the node, linked by sequence number. Where
operations overlap in time, each instant is charged once, to the one that
started first, so that the scopes add up to the device's busy time.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

import torch

MODEL_SCOPES = {"FeatureExtractor": "fe", "PositionalConvEmbedding": "pos_conv",
                "Encoder": "encoder"}
ATTENTION = "attention"
STEP_SCOPES = {"train_step": "attack.step", "eval_step": "attack.eval_step"}
SCORING = "loop.scoring"
WINDOW = "portbench.window"
LABELS = frozenset([*MODEL_SCOPES.values(), ATTENTION, *STEP_SCOPES.values(), SCORING])
OUTSIDE = "outside"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ranged(fn, label: str):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def scopes(runner):
    """Open the benchmark's scopes on ``runner``'s model, steps and loop
    for the duration of the block."""
    from paa_tpu_torch.models import wav2vec2 as program_model
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
        label = MODEL_SCOPES.get(type(module).__name__)
        if label is not None:
            handles.append(module.register_forward_pre_hook(enter(label)))
            handles.append(module.register_forward_hook(leave))
    saved_attention = program_model.attention
    saved_scores = program_loop._scores
    saved_steps = {name: getattr(runner, name) for name in STEP_SCOPES}
    program_model.attention = _ranged(saved_attention, ATTENTION)
    program_loop._scores = _ranged(saved_scores, SCORING)
    for name, label in STEP_SCOPES.items():
        setattr(runner, name, _ranged(saved_steps[name], label))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        program_model.attention = saved_attention
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


def _forward_scopes(cpu: dict) -> dict:
    """Sequence number → innermost scope of the forward operation that made
    that autograd node. An operation records the number the next node will
    take, so the last to record it (by start) made it; only threads that
    enter a scope count."""
    fwd = {}
    for evs in cpu.values():
        if not any(e["name"] in LABELS for e in evs):
            continue
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            seq = e.get("args", {}).get("Sequence number")
            if (seq is not None and "evaluate_function" not in e["name"]
                    and not any("evaluate_function" in s["name"] for s in stack)):
                fwd[seq] = next((s["name"] for s in reversed(stack) if s["name"] in LABELS),
                                OUTSIDE)
            stack.append(e)
    return fwd


def summarize(events: list, top: int = 10) -> dict:
    """The traced window's numbers: ``window_s``, ``busy_s`` (the union of
    device operations inside it), ``device_ops`` (count), ``scope_ms``
    (device ms charged to each scope, adding up to ``busy_s``) and
    ``breakdown``."""
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise RuntimeError("the trace has no window scope")
    w = max(windows, key=lambda e: e["dur"])
    w0, w1 = w["ts"], w["ts"] + w["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device)
    chains, cpu = _chains(events)
    fwd = _forward_scopes(cpu)

    def scope(chain) -> str:
        for e in reversed(chain):
            if e["name"] in LABELS:
                return e["name"]
            if "evaluate_function" in e["name"]:
                return fwd.get(e.get("args", {}).get("Sequence number"), OUTSIDE)
        return OUTSIDE

    # each instant of device activity is charged once, to the operation that
    # started first among those running: Hopper's library kernels launch
    # early and overlap their predecessor, so their durations sum to more
    # than the busy time
    scope_ms = collections.Counter()
    by_name = collections.Counter()
    edge = w0
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], edge), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        edge = b
        scope_ms[scope(chains.get(e.get("args", {}).get("correlation"), []))] += (b - a) / 1e3
        by_name[e["name"][:120]] += (b - a) / 1e6
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((a - edge, edge, a))
        edge = max(edge, b)
    host = _HostClock(cpu.get(w["tid"], []))
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

    def __init__(self, evs: list):
        self.ops = [e for e in evs if e.get("cat") == "cpu_op"]
        self.starts = [e["ts"] for e in self.ops]
        self.scopes = [e for e in evs if e["name"] in LABELS]

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
