"""The program's spans in a trace (``portbench/spans.py``): on a hand-made
trace, the benchmark's summary is the same with them as without them and
their own numbers are as reckoned by hand; on the CPU, with the tiny cell,
the model spans and the benchmark's scopes of the same layers nest one for
one."""

from __future__ import annotations

import collections
import json

import pytest
import torch

from portbench import family, run, spans, trace
from portbench.tests import tiny
from portbench.tests.test_portbench_trace import LABELS, _ev, _trace

CPU = torch.device("cpu")


def _with_spans():
    return _trace() + [
        _ev("user_annotation", "paa.fe", 12, 96),
        _ev("user_annotation", "paa.attention", 202, 46),
        _ev("user_annotation", "paa.update", 390, 30),
        _ev("user_annotation", "paa.score", 705, 235),
        _ev("user_annotation", "paa.score.wait", 718, 104),
    ]


def _remat():
    """A recompute in the backward opens a program span inside the node."""
    return _with_spans() + [_ev("user_annotation", "paa.attention", 305, 10, tid=2)]


@pytest.mark.parametrize("events", [_with_spans, _remat])
def test_the_benchmarks_summary_is_unchanged(events):
    assert trace.summarize(events(), LABELS) == trace.summarize(_trace(), LABELS)


@pytest.mark.parametrize("events", [_trace, _with_spans, _remat])
def test_charge_with_the_benchmarks_labels_is_its_rule(events):
    evs = events()
    w = spans.window(evs)
    got = collections.Counter()
    for name, _e, a, b in spans.charge(evs, LABELS.__contains__, w["ts"], w["ts"] + w["dur"]):
        got[name] += (b - a) / 1e3
    assert dict(got) == trace.summarize(evs, LABELS)["scope_ms"]


def test_span_numbers_by_hand():
    s = spans.summarize(_with_spans())
    # the dgrad of the conv made inside paa.fe is charged to it; the
    # pipelined gemm only for its 250-260 µs
    assert s["span_ms"] == pytest.approx({"paa.fe": 0.14, "paa.attention": 0.04,
                                          "paa.update": 0.09})
    assert sum(s["span_ms"].values()) == pytest.approx(
        trace.summarize(_trace(), LABELS)["busy_s"] * 1e3)
    # paa.score less its wait: 235 - 104 µs
    assert s["span_host_ms"] == pytest.approx({"paa.fe": 0.096, "paa.attention": 0.046,
                                               "paa.update": 0.030, "paa.score": 0.131,
                                               "paa.score.wait": 0.104})
    # device idle while each is innermost: 12-40 and 100-108; 202-220;
    # 400-410; 705-718 and 822-940; 718-822
    assert s["span_idle_ms"] == pytest.approx({"paa.fe": 0.036, "paa.attention": 0.018,
                                               "paa.update": 0.010, "paa.score": 0.131,
                                               "paa.score.wait": 0.104})
    assert spans.per_batch(s, 2) == pytest.approx({
        "update_ms": 0.045, "scoring_host_ms": 0.0655, "scoring_idle_ms": 0.1175})


def test_a_recompute_is_charged_to_the_span_it_runs_in():
    s = spans.summarize(_remat())
    assert s["span_ms"] == pytest.approx({"paa.fe": 0.06, "paa.attention": 0.12,
                                          "paa.update": 0.09})
    # the backward thread's span is no host time of the window's thread
    assert s["span_host_ms"]["paa.attention"] == pytest.approx(0.046)


def test_no_span_no_numbers():
    s = spans.summarize(_trace())
    assert s == {"span_ms": {"outside": pytest.approx(0.27)}, "span_host_ms": {},
                 "span_idle_ms": {}}
    assert spans.per_batch(s, 2) == {}


@pytest.mark.parametrize("mode", ["attack", "eval"])
def test_model_spans_lie_in_the_benchmarks_scopes(mode, tmp_path):
    """One epoch or pass of the tiny cell under the benchmark's scopes:
    each ``paa.fe``, ``paa.pos_conv`` and ``paa.encoder`` lies inside the
    benchmark's scope of the same layer, one for one, and each ``paa.attention``
    around the one of the call it wraps."""
    cell = tiny.cell("wav2vec2-large-lv60", mode, 2 if mode == "attack" else 1)
    r = run.Run(cell, 7, CPU)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with trace.scopes(r.runner, family.program(cell["config"])), \
            torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            r.unit()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for program, bench in spans.HOOKED.items():
        inner = [e for e in events if e["name"] == program]
        outer = [e for e in events if e["name"] == bench]
        assert inner and len(inner) == len(outer), program
        if program == "paa.attention":
            inner, outer = outer, inner
        for e, o in zip(sorted(inner, key=lambda e: e["ts"]), sorted(outer, key=lambda e: e["ts"])):
            assert o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"], program
    got = spans.summarize(events)
    assert got["span_ms"] == {}  # no device operation on the CPU
    assert got["span_host_ms"]["paa.score"] > 0 and got["span_host_ms"]["paa.feed"] > 0
