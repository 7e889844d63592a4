"""The wav2vec2-conformer family and the two cells that came with it: both
cells resolve by name, their counts are pinned to the digit (the conformer's
attention bound is lv60 attack's), the conformer's parameter table and tiny
weights are pinned, the two new readers read a made-up summary, the
family's scopes name the program's classes, and a tiny conformer cell is
``correct`` on the CPU where the control and a fault are not."""

from __future__ import annotations

import hashlib
import importlib.util
import json

import pytest
import torch

from portbench import check, counts, family, faults, inputs, run, trace
from portbench.tests import tiny
from portbench.tests.test_portbench_pins import CELLS
from portbench.tests.tiny import ROOT

CONFORMER = "wav2vec2-conformer-rope-large"
CPU = torch.device("cpu")
# batch FLOPs, the least seconds of a batch's attention calls, and (the
# conformer) of its depthwise-conv calls
NEW_CELLS = {
    "lv60.attack-fm.b32x30s": (90289251680256, 0.02501475112846107, None),
    "conformer.attack-fm.b64x20s": (179767197040640, 0.022220503365112235,
                                    0.00375233704119403),
}
SPECS = "c17fa96b9727ab14e01c82d1685455396505d5afffa87872c97b90052060e1db"
WEIGHTS = "cb6f19585591f6e4ac82dde583edfeae9b6883e27fd3b56ce53d077c70a3b2c4"
ATTACK = {"fe_ms.attack", "encoder_ms.attack", "attention_roofline.attack", "step_mfu.attack",
          "device_idle_pct.attack"}


@pytest.mark.parametrize("name", sorted(NEW_CELLS))
def test_new_cells_resolve_by_name(name):
    cell = run.load_cell(name)
    assert cell["traffic"]["mode"] == "attack" and cell["cell"]["ref_rows"] > 0
    assert [m["name"] for m in cell["end_to_end"]] == ["attack_audio_s_per_s", "peak_mem_gib",
                                                       "setup_s"]
    own = {"conv_module_ms.attack", "dwconv_roofline.attack"}
    if cell["config"]["family"] == "wav2vec2":
        want = ATTACK | {"pos_conv_ms.attack"}
    else:
        want = ATTACK | own
    assert {m["name"] for m in cell["per_layer"]} == want


@pytest.mark.parametrize("name", sorted(NEW_CELLS))
def test_batch_flops_and_bounds(name):
    cell = run.load_cell(name)
    cfg, t = cell["config"], cell["traffic"]
    flops, attention, dwconv = NEW_CELLS[name]
    assert counts.batch_flops(cfg, t["batch_size"], t["samples"], t["mode"]) == flops
    bounds = family.program(cfg).bounds(cfg, t, t["mode"])
    assert bounds["attention"] == attention
    assert bounds.get("dwconv") == dwconv


def test_conformer_attention_bound_is_lv60_attacks():
    assert NEW_CELLS["conformer.attack-fm.b64x20s"][1] == CELLS["lv60.attack-fm.b64x20s"][1]


def test_param_specs_and_weights_pinned():
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{CONFORMER}.json").read_text())
    specs = family.reference(cfg).param_specs(cfg)
    rows = [[k, list(shape), kind] for k, (shape, kind) in specs.items()]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == SPECS
    h = hashlib.sha256()
    for k, v in inputs.weights(tiny.config(CONFORMER), 2**31 + 7, CPU).items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == WEIGHTS


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, run.reader_path(name, ROOT))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_readers_on_a_made_up_summary():
    s = {"scope_ms": {"encoder": 500.0, "conv_module": 30.0, "dwconv": 60.0}, "batches": 6,
         "bound_s": {"attention": 0.02, "dwconv": 0.00375}}
    assert _reader("conv_module_ms.attack")(s) == pytest.approx(15.0)
    assert _reader("dwconv_roofline.attack")(s) == pytest.approx(100 * 0.00375 * 6 / 0.06)
    bare = {**s, "scope_ms": {"encoder": 500.0}}
    assert _reader("conv_module_ms.attack")(bare) is None
    assert _reader("dwconv_roofline.attack")(bare) is None


def test_scopes_name_the_programs_classes():
    cfg = tiny.config(CONFORMER)
    fam = family.program(cfg)
    assert {"fe", "encoder", "conv_module", "dwconv", "attention"} <= trace.labels(fam)
    model = fam.build_model(cfg, inputs.weights(cfg, 3, CPU), CPU)
    names = {type(m).__name__ for m in model.modules()}
    assert set(fam.SCOPES) <= names
    assert fam.model_config(cfg).num_hidden_layers == 2


@pytest.mark.parametrize("mode,accum", [("attack", 2), ("eval", 1)])
def test_tiny_conformer_cell_is_correct_and_the_control_is_not(mode, accum):
    cell = tiny.cell(CONFORMER, mode, accum)
    out = run.execute(cell, 2**31 + 11, 0.0, False, CPU)
    assert out["result"]["correct"], out["checks"]
    r = run.Run(cell, 31, CPU)
    r.window(0.0)
    ok, table = check.verdict(r.numbers(control=True), tiny.LIMITS[mode])
    assert not ok, table


def test_tiny_conformer_cell_with_a_fault_is_not_correct():
    with faults.FAULTS["altered_token"]():
        out = run.execute(tiny.cell(CONFORMER, "attack"), 47, 0.0, False, CPU)
    assert not out["result"]["correct"], out["checks"]
