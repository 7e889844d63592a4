"""The trace's reduction on a hand-made trace, and the readers on the
summaries they read."""

from __future__ import annotations

import importlib.util
import types

import pytest

from portbench import run, trace
from portbench.tests.tiny import ROOT

# the labels of a family whose one model scope is ``fe``
LABELS = trace.labels(types.SimpleNamespace(SCOPES={"FeatureExtractor": "fe"}))


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _trace():
    return [
        _ev("user_annotation", trace.WINDOW, 0, 1000),
        _ev("user_annotation", "attack.step", 0, 600),
        _ev("user_annotation", "fe", 10, 100),
        _ev("cpu_op", "aten::conv1d", 20, 50, **{"Sequence number": 7}),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=1),
        _ev("user_annotation", "attention", 200, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 400, 5, correlation=4),
        # the backward, on its own thread: charged to the forward's scope
        _ev("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 300, 50,
            tid=2, **{"Sequence number": 7}),
        _ev("cuda_runtime", "cudaLaunchKernel", 310, 5, tid=2, correlation=3),
        _ev("user_annotation", trace.SCORING, 700, 250),
        _ev("cpu_op", "aten::item", 720, 100),
        _ev("kernel", "conv_fwd", 40, 60, tid=9, correlation=1),
        _ev("kernel", "attn_fwd", 220, 30, tid=9, correlation=2),
        _ev("kernel", "conv_dgrad", 320, 80, tid=9, correlation=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 410, 90, tid=9, correlation=4),
        # launched early under the attention scope: only 250-260 is its own
        _ev("kernel", "gemm_pdl", 230, 30, tid=9, correlation=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 215, 5, correlation=5),
    ]


def test_summarize():
    s = trace.summarize(_trace(), LABELS)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((60 + 40 + 80 + 90) * 1e-6)
    assert s["device_ops"] == 5
    assert s["scope_ms"] == pytest.approx({"fe": 0.14, "attention": 0.04, "attack.step": 0.09})
    assert sum(s["scope_ms"].values()) == pytest.approx(s["busy_s"] * 1e3)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["loop.scoring > aten::item"] == pytest.approx(500e-6)
    assert s["breakdown"]["device_ops"][0] == ["Memcpy HtoD", pytest.approx(90e-6)]


def _reader(name):
    path = run.reader_path(name, ROOT)
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers():
    s = {"mode": "attack", "scope_ms": {"fe": 20.0, "encoder": 6.0, "attention": 4.0},
         "batches": 2, "batch_flops": 1e12, "window_s": 2.0, "busy_s": 1.5,
         "attention_bound_s": 1e-3, "clips": 10, "clip_seconds": 20.0, "setup_s": 3.0,
         "peak_bytes": 2**31}
    assert _reader("fe_ms.attack")(s) == 10.0
    assert _reader("fe_ms.eval")(s) == 10.0  # one reader; BENCHMARK.json says which cells
    assert _reader("pos_conv_ms.attack")(s) is None  # no scope, nothing read
    assert _reader("encoder_ms.attack")(s) == 5.0
    assert _reader("attention_roofline.attack")(s) == pytest.approx(50.0)
    assert _reader("step_mfu.attack")(s) == pytest.approx(100 * 2e12 / (2.0 * 989e12))
    assert _reader("device_idle_pct.attack")(s) == pytest.approx(25.0)
    assert _reader("attack_audio_s_per_s")(s) == 100.0
    assert _reader("peak_mem_gib")(s) == 2.0
    assert _reader("setup_s")(s) == 3.0
    assert _reader("attention_roofline.attack")({**s, "scope_ms": {}}) is None


def test_a_split_metric_falls_back_to_its_quantitys_reader(tmp_path):
    (tmp_path / "portbench" / "metrics").mkdir(parents=True)
    for name in ("x.py", "y.train.py"):
        (tmp_path / "portbench" / "metrics" / name).write_text("")
    metrics = tmp_path / "portbench" / "metrics"
    assert run.reader_path("x.attack", tmp_path) == metrics / "x.py"
    assert run.reader_path("y.train", tmp_path) == metrics / "y.train.py"
    assert run.reader_path("x", tmp_path) == metrics / "x.py"

