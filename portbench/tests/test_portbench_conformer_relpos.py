"""The wav2vec2-conformer-relpos family and the cell that came with it: the
family's two files load by the configuration's name, its reference imports
nothing of the program, the cell resolves by name with the metrics it
reports, its counts are pinned to the digit, the new reader reads a made-up
summary, the scopes name the program's classes, and a tiny relative-conformer
cell is ``correct`` on the CPU where the control is not."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch

from portbench import check, counts, family, inputs, run, trace
from portbench.tests import tiny
from portbench.tests.test_portbench_imports import FORBIDDEN, _imports
from portbench.tests.tiny import ROOT

RELPOS = "wav2vec2-conformer-rel-pos-large"
CPU = torch.device("cpu")
# batch FLOPs, the least seconds of a batch's attention calls, and of its
# depthwise-conv calls
CELLS = {
    "conformer-relpos.attack-fm.b32x30s": (152543359270912, 0.03573535875494439,
                                           0.0028151918041791043),
}
ATTACK = {"fe_ms.attack", "encoder_ms.attack", "attention_roofline.attack", "step_mfu.attack",
          "device_idle_pct.attack"}


def test_the_family_loads_by_name():
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{RELPOS}.json").read_text())
    assert cfg["family"] == "wav2vec2-conformer-relpos" and cfg["reduced"] == []
    prog, ref = family.program(cfg), family.reference(cfg)
    assert prog.SCOPES["RelativePositions"] == "relpos"
    assert prog.ATTENTION_MODULES == ("paa_tpu_torch.models.wav2vec2_conformer",)
    assert {"KINDS", "Precision", "ctc_losses", "forward", "param_specs"} <= set(dir(ref))
    assert cfg["reference"] == "portbench/reference/wav2vec2-conformer-relpos.py"
    mcfg, preset = prog.model_config(cfg), prog.preset_config(cfg["program_preset"])
    fields = ("position_embeddings_type", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size", "conv_depthwise_kernel_size",
              "max_source_positions", "conv_dim", "conv_kernel", "conv_stride", "conv_bias",
              "feat_extract_norm", "do_normalize", "vocab_size", "layer_norm_eps")
    assert {f: getattr(mcfg, f) for f in fields} == {f: getattr(preset, f) for f in fields}
    with pytest.raises(ValueError, match="relative"):
        prog.model_config({**cfg, "position_embeddings_type": "rotary"})


def test_the_reference_imports_nothing_of_the_program():
    path = ROOT / "portbench" / "reference" / "wav2vec2-conformer-relpos.py"
    assert not _imports(path) & (FORBIDDEN | {"paa_tpu_torch"})


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_resolves_with_its_metrics_and_counts(name):
    cell = run.load_cell(name)
    cfg, t = cell["config"], cell["traffic"]
    assert t["mode"] == "attack" and cell["cell"]["ref_rows"] > 0
    assert [m["name"] for m in cell["end_to_end"]] == ["attack_audio_s_per_s", "peak_mem_gib",
                                                       "setup_s"]
    own = {"conv_module_ms.attack", "dwconv_roofline.attack", "relpos_ms.attack"}
    assert {m["name"] for m in cell["per_layer"]} == ATTACK | own
    flops, attention, dwconv = CELLS[name]
    assert counts.batch_flops(cfg, t["batch_size"], t["samples"], t["mode"]) == flops
    bounds = family.program(cfg).bounds(cfg, t, t["mode"])
    assert bounds["attention"] == attention and bounds.get("dwconv") == dwconv


def test_relpos_reader_on_a_made_up_summary():
    spec = importlib.util.spec_from_file_location("relpos_ms",
                                                  run.reader_path("relpos_ms.attack", ROOT))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.read({"scope_ms": {"encoder": 500.0, "relpos": 24.0}, "batches": 8}) == 3.0
    assert module.read({"scope_ms": {"encoder": 500.0}, "batches": 8}) is None


def test_scopes_name_the_programs_classes():
    cfg = tiny.config(RELPOS)
    fam = family.program(cfg)
    assert {"fe", "encoder", "conv_module", "dwconv", "relpos", "attention"} <= trace.labels(fam)
    model = fam.build_model(cfg, inputs.weights(cfg, 3, CPU), CPU)
    assert set(fam.SCOPES) <= {type(m).__name__ for m in model.modules()}


def test_tiny_relpos_cell_is_correct_and_the_control_is_not():
    cell = tiny.cell(RELPOS, "attack", 2)
    out = run.execute(cell, 2**31 + 13, 0.0, False, CPU)
    assert out["result"]["correct"], out["checks"]
    r = run.Run(cell, 37, CPU)
    r.window(0.0)
    ok, table = check.verdict(r.numbers(control=True), tiny.LIMITS["attack"])
    assert not ok, table
