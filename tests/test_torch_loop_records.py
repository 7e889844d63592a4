"""What the attack loop keeps fixed for its readers: the files a run and a
sweep leave in their directories, which a later run resumes from, and the
names the benchmark's tracer (``portbench/trace.py``) swaps at run time.
Tiny preset, float32, 24 synthetic clips, one epoch, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from paa_tpu_torch.cli import sweep
from paa_tpu_torch.config import AttackConfig
from paa_tpu_torch.data import datasets, pipeline
from paa_tpu_torch.models import wav2vec2
from paa_tpu_torch.train import artifacts, checkpoint, loop

BATCH = 8
SAMPLES = 24
HISTORY = {k: "torch.float64" for k in (
    "train_ctc", "train_wer", "eval_clean_ctc", "eval_clean_wer", "eval_pert_ctc",
    "eval_pert_wer")}
ADAM = {"count": "torch.int32", "mu": "torch.float32", "nu": "torch.float32"}
METRICS_LINE = {"epoch", "train_ctc", "train_wer", "eval_clean_ctc", "eval_clean_wer",
                "eval_pert_ctc", "eval_pert_wer", "step_time_ms", "lr"}

# (state file, its kinds by key, the cell directory under the save root)
ON_DISK = {
    "run": (checkpoint.STATE_FILE, {
        "p": "torch.float32", "opt_state": ADAM, "epoch": "int", "best_epoch": "int",
        "no_improve": "int", "best_eval_score": "float", "best_p": "torch.float32",
        "history": HISTORY,
    }, "."),
    "sweep": ("sweep_state_linf.pt", {
        "p_s": "torch.float32", "opt_s": ADAM, "epoch": "int",
        "best_score_s": "torch.float64", "best_p_s": "torch.float32",
        "best_epoch_s": "torch.int64", "no_improve_s": "torch.int64",
        "history_s": [HISTORY, HISTORY], "clean_eval": "torch.float64",
    }, os.path.join("untargeted", "synthetic", "linf_0.01_untargeted_adam")),
}
FINGERPRINT = {"cfg", "sizes", "audio_len", "dataset", "data_root", "synthetic_samples",
               "synthetic_words", "n_train"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: pytest workers sharing the cores slow a tiny
    run down far more than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_plots(monkeypatch):
    monkeypatch.setattr(artifacts, "HAVE_MPL", False)


@pytest.fixture(scope="module")
def pipe():
    return pipeline.build_pipeline(
        datasets.load_dataset_tuples("synthetic", synthetic_samples=SAMPLES), seed=5)


@pytest.fixture(scope="module")
def model():
    return wav2vec2.init_model(wav2vec2.get_config("wav2vec2-tiny"), seed=0)


def _cfg(**over):
    kw = dict(norm_type="linf", optimizer_type="adam", lr=1e-3, batch_size=BATCH, num_epochs=1,
              model_name="wav2vec2-tiny")
    return AttackConfig(**{**kw, **over})


def _sweep_args(root, cells):
    return sweep.parse_args([
        "--platform", "cpu", "--dataset", "synthetic", "--synthetic_samples", str(SAMPLES),
        "--model", "wav2vec2-tiny", "--compute_dtype", "float32",
        "--batch_size", str(BATCH), "--num_epochs", "1", "--optimizer_type", "adam",
        "--num_items_to_inspect", "0", "--norms", "linf",
        "--grid", json.dumps({"linf": cells}), "--save_root", str(root)])


def _kinds(x):
    """The key sets and dtypes of a checkpoint as torch.load gives it back."""
    if isinstance(x, dict):
        return {k: _kinds(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_kinds(v) for v in x]
    return str(x.dtype) if isinstance(x, torch.Tensor) else type(x).__name__


@pytest.mark.parametrize("mode", sorted(ON_DISK))
def test_checkpoint_and_metrics_line_formats(tmp_path, model, pipe, mode):
    """The state file's keys and dtypes and a metrics.jsonl line's keys,
    as a resumed run reads them and as earlier runs wrote them."""
    state_file, want, cell = ON_DISK[mode]
    if mode == "run":
        loop.run_attack(_cfg(), model, pipe, str(tmp_path), num_items_to_inspect=0)
    else:
        sweep.run_sweep(_sweep_args(tmp_path, [0.01, 0.02]))
        with open(tmp_path / (state_file + ".json")) as f:
            assert set(json.load(f)) == FINGERPRINT
    state = torch.load(tmp_path / state_file, map_location="cpu", weights_only=True)
    assert _kinds(state) == want
    with open(tmp_path / cell / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0]
    assert set(lines[0]) == METRICS_LINE


def test_tracer_swaps_reach_the_loop(tmp_path, model, pipe, monkeypatch):
    """The train pass, the eval pass and a two-cell sweep epoch score
    through ``loop._scores`` looked up at call time, and ``train_epoch`` and
    ``evaluate`` run whatever step the runner's attribute holds then."""
    calls = []
    scores = loop._scores

    def counting(*args, **kwargs):
        calls.append(1)
        return scores(*args, **kwargs)

    monkeypatch.setattr(loop, "_scores", counting)
    runner = loop.AttackRunner(_cfg(optimizer_type="pgd"), model, pipe, mesh=None)
    steps = []

    def wrap(name):
        step = getattr(runner, name)
        setattr(runner, name, lambda *a: steps.append(name) or step(*a))

    wrap("train_step")
    wrap("eval_step")
    p = runner.init_perturbation(0)
    runner.train_epoch(p, None, 0, np.random.default_rng(0))
    n_train = -(-len(pipe.train) // BATCH)
    assert (len(calls), steps) == (1, ["train_step"] * n_train)
    runner.evaluate(pipe.eval, p, perturbed=True)
    n_eval = -(-len(pipe.eval) // BATCH)
    assert (len(calls), steps[n_train:]) == (2, ["eval_step"] * n_eval)

    del calls[:]
    sweep.run_sweep(_sweep_args(tmp_path, [0.01, 0.02]))
    # one epoch: the clean eval, and each cell's train and perturbed eval
    # scores; then the clean test and each cell's perturbed test
    assert len(calls) == 1 + 2 * 2 + 1 + 2
