"""The program's spans (``paa_tpu_torch/spans.py``): nothing opened without
a profiler, and under ``torch.profiler`` each span where its work happens,
as often as that work happens, on a tiny runner on the CPU."""

import collections
import json
import pathlib

import numpy as np
import pytest
import torch

from paa_tpu_torch import spans
from paa_tpu_torch.cli import parser, run_attack
from paa_tpu_torch.config import AttackConfig
from paa_tpu_torch.data import datasets, pipeline
from paa_tpu_torch.models import wav2vec2
from paa_tpu_torch.train import loop

BATCH = 4
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pipe():
    return pipeline.build_pipeline(
        datasets.load_dataset_tuples("synthetic", synthetic_samples=24), seed=5)


@pytest.fixture(scope="module")
def model():
    return wav2vec2.init_model(wav2vec2.get_config("wav2vec2-tiny"), seed=0)


def _runner(model, pipe, accum_steps=1, device_cache=None):
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=1e-3,
                       batch_size=BATCH, accum_steps=accum_steps, model_name="wav2vec2-tiny",
                       cache_data_on_device=device_cache)
    return loop.AttackRunner(cfg, model, pipe, mesh=None)


# opened only by the conformer's conv module and the relative conformer's
# positions, which the tiny wav2vec2 lacks
CONFORMER_SPANS = {"paa.conv_module", "paa.dwconv", "paa.relpos"}


def _epoch(runner):
    """One epoch of PGD, which keeps no optimizer state."""
    runner.train_epoch(runner.init_perturbation(0), None, 0, np.random.default_rng(0))


def _counts(fn) -> collections.Counter:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events() if e.name in spans.SPANS)


def _refuse(*_args, **_kwargs):
    raise AssertionError("record_function called with no profiler running")


def test_no_profiler_opens_nothing(model, pipe, monkeypatch):
    """A train epoch and an eval pass, the device feed's too, never reach
    ``record_function`` while no profiler runs."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    for device_cache in (None, True):
        runner = _runner(model, pipe, accum_steps=2, device_cache=device_cache)
        _epoch(runner)
        runner.evaluate(pipe.eval, runner.init_perturbation(0), perturbed=True)


def _expected(batches, microbatches, layers, steps) -> dict:
    return {"paa.feed": batches, "paa.ctc": microbatches, "paa.update": steps,
            "paa.score": 1, "paa.score.wait": 2 * batches, "paa.fe": microbatches,
            "paa.pos_conv": microbatches, "paa.encoder": microbatches,
            "paa.attention": layers * microbatches}


@pytest.mark.parametrize("device_cache", [None, True], ids=["host_feed", "device_feed"])
@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_epoch_spans(model, pipe, accum_steps, device_cache):
    runner = _runner(model, pipe, accum_steps, device_cache)
    batches = -(-len(pipe.train) // BATCH)
    got = _counts(lambda: _epoch(runner))
    layers = model.cfg.num_hidden_layers
    assert got == _expected(batches, batches * accum_steps, layers, batches)


@pytest.mark.parametrize("device_cache", [None, True], ids=["host_feed", "device_feed"])
def test_evaluate_spans(model, pipe, device_cache):
    runner = _runner(model, pipe, device_cache=device_cache)
    p = runner.init_perturbation(0)
    batches = -(-len(pipe.eval) // BATCH)
    got = _counts(lambda: runner.evaluate(pipe.eval, p, perturbed=True))
    want = _expected(batches, batches, model.cfg.num_hidden_layers, 0)
    del want["paa.update"]
    assert got == want


def test_every_span_is_emitted(model, pipe):
    """Every span but the conformer's own (``tests/test_torch_conformer.py``)."""
    runner = _runner(model, pipe)
    got = _counts(lambda: (_epoch(runner),
                           runner.evaluate(pipe.eval, runner.init_perturbation(0), True)))
    assert set(got) == set(spans.SPANS) - CONFORMER_SPANS


def test_spans_nest_as_the_model_does(model, pipe):
    """``paa.pos_conv`` lies inside ``paa.encoder``, each ``paa.attention``
    inside one, and ``paa.score.wait`` inside ``paa.score``."""
    runner = _runner(model, pipe)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _epoch(runner)
    events = [e for e in prof.events() if e.name in spans.SPANS]
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e.name].append((e.time_range.start, e.time_range.end))

    def inside(name, outer):
        return all(any(a <= s and t <= b for a, b in by_name[outer]) for s, t in by_name[name])

    assert inside("paa.pos_conv", "paa.encoder")
    assert inside("paa.attention", "paa.encoder")
    assert inside("paa.score.wait", "paa.score")
    assert not any(a < s < b for a, b in by_name["paa.fe"] for s, _ in by_name["paa.encoder"])


def test_run_attack_profile_holds_every_span(tmp_path):
    """``run_attack --profile`` writes the spans into its trace with no
    change to the exporter."""
    ckpt = REPO / "checkpoints" / "wav2vec2-tiny-synthetic.safetensors"
    args = parser.parse_args(
        ["--platform", "cpu", "--model", "wav2vec2-tiny", "--checkpoint_path", str(ckpt),
         "--dataset", "synthetic", "--synthetic_samples", "48", "--small_data",
         "--batch_size", "8", "--num_epochs", "1", "--optimizer_type", "pgd",
         "--num_items_to_inspect", "0", "--profile", "--save_root", str(tmp_path)])
    assert run_attack.main(args) == 0
    trace = pathlib.Path(run_attack.make_save_dir(args)) / "profile" / "trace.json"
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(spans.SPANS) - CONFORMER_SPANS <= names
