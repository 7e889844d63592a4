"""On the card only: one short run of a cell through the command, and the
control at a cell's own size failing the check. Each skips without a CUDA
device, decided inside the fixture.

    python3 -m pytest portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.tiny import ROOT

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    from portbench import system

    return system.device()


def test_one_short_run(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "base.eval.b64x10s", "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {"eval_audio_s_per_s", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"


def test_control_fails_at_the_cells_size(card):
    from portbench import check
    from portbench.run import Run, load_cell

    cell = load_cell("base.eval.b64x10s")
    run = Run(cell, 12345, card)
    run.window(0.0)
    run.free()
    ok, table = check.verdict(run.numbers(control=True), cell["cell"]["limits"])
    assert not ok, table
