"""``counts.py`` against the figures reckoned by hand from the widths."""

from __future__ import annotations

import json

import pytest

from portbench import counts
from portbench.tests.tiny import ROOT


def _cfg(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,samples,forward,attack", [
    ("wav2vec2-base", 160_000, 9.48, 19.55),
    ("wav2vec2-large-lv60", 320_000, 52.32, 110.92),
])
def test_batch_flops(name, samples, forward, attack):
    cfg = _cfg(name)
    assert counts.batch_flops(cfg, 64, samples, "eval") / 1e12 == pytest.approx(forward, abs=0.005)
    assert counts.batch_flops(cfg, 64, samples, "attack") / 1e12 == pytest.approx(attack,
                                                                                   abs=0.01)


def test_attention_bounds_at_k4():
    c = counts.attention_call(32, 999, 16, 64)
    assert counts.least_seconds(c["fwd_flops"], c["fwd_bytes"]) * 1e3 == pytest.approx(
        0.1323, abs=5e-5)
    assert counts.least_seconds(c["bwd_flops"], c["bwd_bytes"]) * 1e3 == pytest.approx(
        0.3307, abs=5e-5)


def test_batch_attention_seconds():
    cfg = _cfg("wav2vec2-large-lv60")
    per_call = counts.attention_call(32, 999, 16, 64)
    one = (counts.least_seconds(per_call["fwd_flops"], per_call["fwd_bytes"])
           + counts.least_seconds(per_call["bwd_flops"], per_call["bwd_bytes"]))
    assert counts.batch_attention_seconds(cfg, 64, 320_000, "attack", 2) == pytest.approx(
        2 * 24 * one)
    assert counts.frames(cfg, 320_000) == 999
    assert counts.frames(_cfg("wav2vec2-base"), 160_000) == 499
