"""The comparison that decides ``correct``, driven on the CPU at a tiny
size: the run after the look for a chip (``run.execute``) with the sound
program, with the control put in the program's place, and with the timed
path broken underneath by each fault the cells can have."""

from __future__ import annotations

import pytest
import torch

from portbench import check, faults, run
from portbench.tests import tiny

CPU = torch.device("cpu")
CASES = [("wav2vec2-large-lv60", "attack", 2), ("wav2vec2-base", "attack", 1),
         ("wav2vec2-base", "eval", 1), ("wav2vec2-large-lv60", "eval", 1)]


def _run(cell: dict, seed: int) -> run.Run:
    r = run.Run(cell, seed, CPU)
    r.window(0.0)
    return r


@pytest.mark.parametrize("config,mode,accum", CASES)
def test_sound_program_is_correct(config, mode, accum):
    out = run.execute(tiny.cell(config, mode, accum), 2**31 + 11, 0.0, False, CPU)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["attempted"] == 8
    assert set(out["checks"]) == set(tiny.LIMITS[mode])
    assert f"{mode}_audio_s_per_s" in out["result"]["metrics"]
    assert "peak_mem_gib" not in out["result"]["metrics"]  # no device number off the card


@pytest.mark.parametrize("config,mode,accum", CASES[1:3])
def test_control_is_not_correct(config, mode, accum):
    r = _run(tiny.cell(config, mode, accum), 31)
    ok, table = check.verdict(r.numbers(control=True), tiny.LIMITS[mode])
    assert not ok, table


FAULT_CASES = [("unchanged_state", "attack"), ("half_batch", "attack"),
               ("altered_token", "attack"), ("k3_norm_high", "attack"), ("half_batch", "eval"),
               ("altered_token", "eval")]


@pytest.mark.parametrize("fault,mode", FAULT_CASES)
def test_fault_is_not_correct(fault, mode):
    with faults.FAULTS[fault]():
        out = run.execute(tiny.cell("wav2vec2-base", mode), 47, 0.0, False, CPU)
    assert not out["result"]["correct"], out["checks"]


def test_a_row_from_nowhere_fails():
    r = _run(tiny.cell("wav2vec2-base", "eval"), 5)
    b = r.positions[0]
    r.records[b] = r.records[b]._replace(heads=r.records[b].heads + 1.0)
    ok, _ = check.verdict(r.numbers(), tiny.LIMITS["eval"])
    assert not ok


def test_eval_keeps_the_last_pass_of_each_checked_position():
    r = _run(tiny.cell("wav2vec2-base", "eval"), 5)
    r.window(0.0)
    assert sorted(r.records) == r.positions and len(r.positions) == 2


def test_attack_checks_the_windows_last_epoch():
    r = run.Run(tiny.cell("wav2vec2-base", "attack"), 5, CPU)
    assert r.records == []  # set-up's warm-up step is not recorded
    r.window(0.0)
    first = [rec.p_in for rec in r.records]
    assert torch.equal(first[0], r.p0) and len(first) == 2  # both steps of the epoch
    r.window(0.0)
    assert len(r.records) == 2
    assert not torch.equal(r.records[0].p_in, r.p0)  # the second epoch starts where p moved to
    assert torch.equal(r.records[1].p_in, r.records[0].p_out)

