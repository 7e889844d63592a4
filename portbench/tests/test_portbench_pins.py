"""What the harness computes for the committed cells, pinned to the digit:
the FLOPs and the attention bound of a batch that the traced summary
carries, the parameter table that orders the weight draw, and the weights
drawn at a fixed seed. A change to how the harness is laid out moves none
of them; a change that does moves the ledger's per-layer readings."""

from __future__ import annotations

import hashlib
import importlib.util
import json

import pytest
import torch

from portbench import counts, inputs, run
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

# batch FLOPs (integers) and the least seconds of a batch's attention calls
CELLS = {
    "lv60.attack-fm.b64x20s": (110921599680512, 0.022220503365112235),
    "base.attack-fm.b64x10s": (19550428463104, 0.002193352700940193),
    "base.eval.b64x10s": (9481480699904, 0.0007083500131343283),
    "lv60.eval.b64x20s": (52321360150528, 0.006348715247174924),
}
# sha256 of the (name, shape, kind) rows of each configuration's parameters, in order
SPECS = {
    "wav2vec2-base": "ebb3ff6b83e652934957f09414018525c1e4e639e37b47f32e921b3b0877ea74",
    "wav2vec2-large-lv60": "d8c9d7e5ee35fc42527df5a3bfa92345c57809bb0a1ce37f41acbdbb7a0730ec",
}
# sha256 of the weights drawn at tiny's widths from seed 2**31 + 7 on the CPU
WEIGHTS = {
    "wav2vec2-base": "b9dcc3fd122f10b8c1c4a58204ecbab604aa330abf4d87f4a248670aae53a689",
    "wav2vec2-large-lv60": "19231594c3161c4265b2aac76bc9eda31f512f73a71adcc19750e2f9071cebfb",
}


def _reference(cfg: dict):
    """The plain reference that the configuration file names."""
    spec = importlib.util.spec_from_file_location("pinned_reference", ROOT / cfg["reference"])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(CELLS))
def test_batch_flops_and_attention_bound(name):
    cell = run.load_cell(name)
    cfg, t = cell["config"], cell["traffic"]
    flops, bound = CELLS[name]
    assert counts.batch_flops(cfg, t["batch_size"], t["samples"], t["mode"]) == flops
    assert counts.batch_attention_seconds(cfg, t["batch_size"], t["samples"], t["mode"],
                                          t.get("accum_steps", 1)) == bound


@pytest.mark.parametrize("name", sorted(SPECS))
def test_param_specs(name):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    rows = [[k, list(shape), kind] for k, (shape, kind) in _reference(cfg).param_specs(cfg).items()]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == SPECS[name]


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_at_a_fixed_seed(name):
    h = hashlib.sha256()
    for k, v in inputs.weights(tiny.config(name), 2**31 + 7, torch.device("cpu")).items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[name]
