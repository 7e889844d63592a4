"""The port's entry points under ``torchrun``: ``run_attack`` and ``sweep``
on 2 gloo ranks against the same runs in one process.

Each 2-rank run is ``python -m torch.distributed.run --standalone
--nproc_per_node 2`` of ``torch_parallel_ranks.py cli``, which calls the
entry point's ``main`` in every rank, records what rank 1 opens for writing
under the save root (it must be nothing: rank 0 alone writes) and which JAX
modules it imported (none). The 2-rank runs are launched together and the
one-process runs computed meanwhile. Tiny committed checkpoint in float32,
48 synthetic clips, batch 8, on the CPU.

Tolerances: a run whose batches split over the ranks sums each batch's CTC
in another order, so its perturbed scores (after 2 epochs of sign steps)
agree within 1e-5 relative; its clean scores depend on no step and are
equal; so are runs whose ranks do not split the batch (one sweep cell per
rank), and a resumed 2-rank run and an uninterrupted one.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks  # tests/ is on sys.path
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.cli import run_attack as trun
from paa_tpu_torch.cli import sweep
from paa_tpu_torch.train import artifacts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")
RUN = ["--platform", "cpu", "--model", "wav2vec2-tiny", "--checkpoint_path", TINY_CKPT,
       "--compute_dtype", "float32", "--dataset", "synthetic", "--synthetic_samples", "48",
       "--batch_size", "8", "--norm_type", "fletcher_munson", "--optimizer_type", "pgd",
       "--lr", "5e-3", "--num_items_to_inspect", "2", "--early_stopping", "4"]
SWEEP = ["--platform", "cpu", "--model", "wav2vec2-tiny", "--compute_dtype", "float32",
         "--dataset", "synthetic", "--synthetic_samples", "24", "--synthetic_words", "3,4",
         "--batch_size", "8", "--optimizer_type", "pgd", "--lr", "5e-3",
         "--num_items_to_inspect", "0", "--norms", "linf"]
# linf ε=0 projects p to 0 every step: that cell improves once and stops
# after 2 flat epochs, and the survivor runs on, rebuilt over both ranks
SWEEPS = {"two_cells": ["--grid", json.dumps({"linf": [5e-3, 2e-2]}), "--num_epochs", "2",
                        "--early_stopping", "99"],
          "early_stop": ["--grid", json.dumps({"linf": [0.0, 2e-2]}), "--num_epochs", "4",
                         "--early_stopping", "2"]}
# name → (module, argv); "resumed" first runs "interrupted"'s epoch, then 2
LAUNCHES = {
    "dp": ("run_attack", RUN + ["--num_epochs", "2"]),
    # every rank stages the splits on its own device and gathers the global
    # batch; fletcher_munson never reads the padding rows the feeds differ in
    "dp_device_cache": ("run_attack", RUN + ["--num_epochs", "2", "--device_cache"]),
    "tp": ("run_attack", RUN + ["--num_epochs", "2", "--tp", "2"]),
    "interrupted": ("run_attack", RUN + ["--num_epochs", "1"]),
    "sweep_two_cells": ("sweep", SWEEP + SWEEPS["two_cells"]),
    "sweep_early_stop": ("sweep", SWEEP + SWEEPS["early_stop"]),
}


@pytest.fixture(autouse=True, scope="module")
def no_plots():
    """No PNGs: matplotlib would take most of these runs' time."""
    have = artifacts.HAVE_MPL
    artifacts.HAVE_MPL = False
    yield
    artifacts.HAVE_MPL = have


def _launch(workdir: str, module: str, argv: list[str], root: str) -> dict:
    with open(os.path.join(workdir, "argv.json"), "w") as f:
        json.dump({"module": module, "argv": argv + ["--save_root", root], "save_root": root},
                  f)
    ranks.launch(2, "cli", workdir, timeout=180.0)
    return {r: json.load(open(os.path.join(workdir, f"rank{r}.json"))) for r in range(2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank run (name → (save root, per-rank records)) and the
    one-process runs (name → save root)."""
    base = tmp_path_factory.mktemp("runs")
    two, errors = {}, {}

    def go(name, module, argv, then=None):
        try:
            root = str(base / name)
            work = str(base / f"{name}_work")
            os.makedirs(work)
            two[name] = (root, _launch(work, module, argv, root))
            if then is not None:  # the same root, resumed to 2 epochs
                work = str(base / f"{then}_work")
                os.makedirs(work)
                two[then] = (root, _launch(work, module, RUN + ["--num_epochs", "2"], root))
        except RuntimeError as e:
            errors[name] = e

    threads = [threading.Thread(target=go, args=(name, module, argv),
                                kwargs={"then": "resumed" if name == "interrupted" else None})
               for name, (module, argv) in LAUNCHES.items()]
    for t in threads:
        t.start()
    one = {}
    torch.set_num_threads(1)
    for name in ("dp", "sweep_two_cells", "sweep_early_stop"):
        module, argv = LAUNCHES[name]
        root = str(base / f"one_{name}")
        if module == "run_attack":
            assert trun.main(tparser.parse_args(argv + ["--save_root", root])) == 0
        else:
            assert sweep.main(argv + ["--save_root", root]) == 0
        one[name] = root
    for t in threads:
        t.join()
    assert not errors, errors
    return two, one


def _run_dir(root: str) -> str:
    (run_dir,) = [d for d, _, files in os.walk(root) if "results.json" in files]
    return run_dir


def _results(root: str) -> dict:
    return json.load(open(os.path.join(_run_dir(root), "results.json")))


@pytest.mark.parametrize("name", ["dp", "tp", "dp_device_cache"])
def test_run_attack_on_two_ranks_matches_one_process(runs, name):
    """dp=2 (the batch split), --tp 2 (the heads split) and dp=2 on the
    device feed, against one process on the host feed: clean test scores
    equal, perturbed within 1e-5 relative."""
    two, one = runs
    got, want = _results(two[name][0]), _results(one["dp"])
    assert got["finished_training"] is True
    assert got["final_test_clean"] == want["final_test_clean"]
    for key in ("final_test_perturbed", "eval_score_perturbed"):
        np.testing.assert_allclose([got[key]["ctc"], got[key]["wer"]],
                                   [want[key]["ctc"], want[key]["wer"]], rtol=1e-5)
    staged = "staged split to device" in open(os.path.join(_run_dir(two[name][0]),
                                                           "train.log")).read()
    assert staged == (name == "dp_device_cache")
    np.testing.assert_allclose(np.load(os.path.join(_run_dir(two[name][0]), "perturbation.npy")),
                               np.load(os.path.join(_run_dir(one["dp"]), "perturbation.npy")),
                               rtol=1e-5, atol=1e-7)


def test_resumed_two_rank_run_equals_uninterrupted(runs):
    """1 epoch on 2 ranks, then the same root resumed to 2: the result of 2
    uninterrupted epochs on 2 ranks, bit for bit."""
    two, _ = runs
    got, want = two["resumed"][0], two["dp"][0]
    assert _results(got) == {**_results(want), **{k: _results(got)[k] for k in
                                                  ("steps_per_sec",)}}
    np.testing.assert_array_equal(np.load(os.path.join(_run_dir(got), "perturbation.npy")),
                                  np.load(os.path.join(_run_dir(want), "perturbation.npy")))
    lines = [json.loads(line) for line in open(os.path.join(_run_dir(got), "metrics.jsonl"))]
    assert [line["epoch"] for line in lines] == [0, 1]


def _cells(root: str) -> list[dict]:
    return json.load(open(os.path.join(root, "sweep_results.json")))["linf"]["cells"]


def test_two_cell_sweep_on_two_ranks_equals_one_process(runs):
    """One cell per rank (sweep=2, data=1): each rank runs its cell's steps
    on the whole batch, as one process does, so every number is equal."""
    two, one = runs
    summary = json.load(open(os.path.join(two["sweep_two_cells"][0], "sweep_results.json")))
    assert summary["linf"]["mesh"] == "(sweep=2, data=1)"
    for got, want in zip(_cells(two["sweep_two_cells"][0]), _cells(one["sweep_two_cells"])):
        for key in ("size", "best_epoch", "final_ctc", "test_clean_ctc", "test_clean_wer",
                    "test_pert_ctc", "test_pert_wer", "best_eval_pert_ctc"):
            assert got[key] == want[key], key
        np.testing.assert_array_equal(np.load(os.path.join(got["dir"], "perturbation.npy")),
                                      np.load(os.path.join(want["dir"], "perturbation.npy")))


def test_sweep_rebuilt_after_an_early_stop_matches_one_process(runs):
    """The ε=0 cell stops after epoch 2; the survivor's cells are rebuilt
    over both ranks (sweep=1, data=2, the batch split) for epoch 3, without a
    hang; every cell within 1e-5 relative of the one-process sweep."""
    two, one = runs
    root = two["sweep_early_stop"][0]
    summary = json.load(open(os.path.join(root, "sweep_results.json")))["linf"]
    assert summary["programs_built"] == [1, 2]
    for got, want in zip(summary["cells"], _cells(one["sweep_early_stop"])):
        assert got["best_epoch"] == want["best_epoch"]
        np.testing.assert_allclose([got[k] for k in ("test_pert_ctc", "test_clean_ctc",
                                                     "final_ctc")],
                                   [want[k] for k in ("test_pert_ctc", "test_clean_ctc",
                                                      "final_ctc")], rtol=1e-5)
        lines = open(os.path.join(got["dir"], "metrics.jsonl")).read().splitlines()
        assert len(lines) == len(open(os.path.join(want["dir"], "metrics.jsonl"))
                                 .read().splitlines())


@pytest.mark.parametrize("name", list(LAUNCHES) + ["resumed"])
def test_only_rank_zero_writes_and_no_rank_imports_jax(runs, name):
    two, _ = runs
    records = two[name][1]
    assert records[1]["written"] == []
    assert records[0]["jax_modules"] == records[1]["jax_modules"] == []
