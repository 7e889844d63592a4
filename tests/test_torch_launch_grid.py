"""The port's process-level grid launcher (``paa_tpu_torch.cli.launch_grid``)
against ``tests/test_launch_grid.py``'s cases: round-robin cells, one
``paa_tpu_torch.cli.run_attack`` command per cell, the unknown-norm and
missing-size-flag errors, and a failing cell requeued and then reported."""

import json
import os

import pytest

from paa_tpu.cli import launch_grid as jgrid
from paa_tpu_torch.cli import launch_grid


def test_build_cells_round_robin():
    grids = {"a": [1.0, 2.0, 3.0], "b": [10.0], "c": [5.0, 6.0]}
    cells = launch_grid.build_cells(["a", "b", "c"], grids)
    assert cells == [("a", 1.0), ("b", 10.0), ("c", 5.0), ("a", 2.0), ("c", 6.0), ("a", 3.0)]
    assert cells == jgrid.build_cells(["a", "b", "c"], grids)


def test_dry_run_prints_one_port_command_per_cell(capsys):
    argv = ["--norms", "max_phon,l2", "--dry_run", "--save_root", "/tmp/x",
            "--num_epochs", "2", "--dataset", "synthetic"]
    assert launch_grid.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert jgrid.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(want) == 8  # 5 max_phon sizes + 3 l2 sizes
    assert "--norm_type max_phon" in lines[0] and "--max_phon_level 15.0" in lines[0]
    assert "--norm_type l2" in lines[1] and "--l2_size 0.04" in lines[1]
    for got, ref in zip(lines, want):
        assert "-m paa_tpu_torch.cli.run_attack " in got
        assert "--num_epochs 2" in got and "--save_root /tmp/x" in got
        # the same command as the JAX launcher's, but for the module it runs
        assert got == ref.replace("paa_tpu.cli.run_attack", "paa_tpu_torch.cli.run_attack")


def test_unknown_norm_is_an_error():
    with pytest.raises(SystemExit):
        launch_grid.main(["--norms", "nope", "--dry_run"])


def test_grid_norm_without_size_flag_is_an_error():
    with pytest.raises(SystemExit, match="unknown norm"):
        launch_grid.main(["--norms", "maxphon", "--grid", '{"maxphon": [15.0]}', "--dry_run"])


def test_failed_cell_is_requeued_then_reported(tmp_path):
    """A cell whose process exits nonzero re-enters the queue up to
    --retries times, and the grid exits 1 with every attempt recorded."""
    rc = launch_grid.main(["--norms", "linf", "--save_root", str(tmp_path), "--retries", "1",
                           "--bogus_flag_that_run_attack_rejects"])
    assert rc == 1
    record = json.load(open(tmp_path / "grid_jobs.json"))
    assert len(record) == 1
    assert record[0]["attempts"] == 2
    assert len(record[0]["returncodes"]) == 2 and all(c != 0 for c in record[0]["returncodes"])
    assert "paa_tpu_torch.cli.run_attack" in record[0]["cmd"]
    assert sorted(os.listdir(tmp_path / "grid_logs")) == [
        "linf_0.0001_attempt0.log", "linf_0.0001_attempt1.log"]
    log = (tmp_path / "grid_logs" / "linf_0.0001_attempt0.log").read_text()
    assert "bogus_flag_that_run_attack_rejects" in log
