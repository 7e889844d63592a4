"""A new model family is new files only. In a copy of the harness, a family
``wav2vec2-copy`` (wav2vec2's two family files under the new name, its
reference with one weight kind of its own) gets a configuration, a traffic
mix, a cell's check and the entries in ``BENCHMARK.json``; with no file of
the copy edited, the harness resolves the cell, the program's model
configuration, the weights, the batch's FLOPs and bounds, the scope
labels and the reference's forward through the family's name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from portbench.tests import tiny
from portbench.tests.test_portbench_pins import CELLS
from portbench.tests.tiny import ROOT

# appended to the reference's copy: one parameter of a kind that
# portbench/inputs.py does not draw, as a BatchNorm's running variance
EXTRA_KIND = '''

KINDS = {"running_var": lambda x, shape, cfg: 1.0 + 0.1 * x.abs()}
_param_specs = param_specs


def param_specs(cfg: dict) -> dict:
    return {**_param_specs(cfg), "extra.running_var": ((cfg["hidden_size"],), "running_var")}
'''

PROBE = """
import json, math, sys, torch
sys.path[:0] = [".", sys.argv[2]]  # the copy's harness, the repository's program
from portbench import counts, family, inputs, run, trace
cell = run.load_cell("copy.attack-fm.b64x20s")
cfg, t = cell["config"], cell["traffic"]
fam, ref = family.program(cfg), family.reference(cfg)
out = {"files": [fam.__file__, ref.__file__]}
out["model_config"] = fam.model_config(cfg) == fam.preset_config("wav2vec2-large-lv60")
out["batch_flops"] = counts.batch_flops(cfg, t["batch_size"], t["samples"], t["mode"])
out["bound_s"] = fam.bounds(cfg, t, t["mode"])
out["labels"] = sorted(trace.labels(fam))
small = {**cfg, **json.loads(sys.argv[1])}
w = inputs.weights(small, 5, torch.device("cpu"))
total = sum(math.prod(s) for s, _ in ref.param_specs(small).values())
draw = torch.randn(total, generator=torch.Generator().manual_seed(5))
extra = 1.0 + 0.1 * draw[-small["hidden_size"]:].abs()
out["extra"] = torch.equal(w["extra.running_var"], extra)
plain = {**small, "family": "wav2vec2"}
out["names"] = list(w)[:-1] == list(inputs.weights(plain, 5, torch.device("cpu")))
params = {k: v.float() for k, v in w.items()}
audio = 0.1 * torch.randn((2, 16000), generator=torch.Generator().manual_seed(1))
with torch.no_grad():
    got = ref.forward(params, small, audio)
    want = family.reference(plain).forward(params, small, audio)
out["forward"] = [list(got.shape), torch.equal(got, want)]
print(json.dumps(out))
"""


def _copy_of_the_harness(root):
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def test_a_new_family_needs_no_harness_edit(tmp_path):
    root = tmp_path / "checkout"
    before = _copy_of_the_harness(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "wav2vec2-large-lv60.json").read_text())
    cfg.update(name="wav2vec2-copy", family="wav2vec2-copy")
    new = {
        pb / "families" / "wav2vec2-copy.py": (pb / "families" / "wav2vec2.py").read_text(),
        pb / "reference" / "wav2vec2-copy.py": (pb / "reference" / "wav2vec2.py").read_text()
        + EXTRA_KIND,
        pb / "configs" / "wav2vec2-copy.json": json.dumps(cfg),
        pb / "traffic" / "copy.attack-fm.b64x20s.json":
            (pb / "traffic" / "attack-fm.b64x20s.json").read_text(),
        pb / "workloads" / "copy.attack-fm.b64x20s.json":
            (pb / "workloads" / "lv60.attack-fm.b64x20s.json").read_text(),
    }
    for path, text in new.items():
        assert not path.exists(), path
        path.write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wav2vec2-copy", "source": cfg["source"],
                             "file": "portbench/configs/wav2vec2-copy.json", "reduced": [],
                             "why": "a second family laid out by name"})
    bench["workloads"].append({"name": "copy.attack-fm.b64x20s", "config": "wav2vec2-copy",
                               "traffic": "copy.attack-fm.b64x20s", "chips": 1,
                               "why": "lv60's attack under the copied family"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", PROBE, json.dumps(tiny.TINY), str(ROOT)],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["files"] == [str(pb / "families" / "wav2vec2-copy.py"),
                            str(pb / "reference" / "wav2vec2-copy.py")]
    assert got["model_config"]
    flops, bound = CELLS["lv60.attack-fm.b64x20s"]
    assert got["batch_flops"] == flops and got["bound_s"] == {"attention": bound}
    assert {"fe", "pos_conv", "encoder", "attention"} <= set(got["labels"])
    assert got["extra"] and got["names"]
    assert got["forward"][1] and got["forward"][0][0] == 2
    # every file that was there before is as it was; BENCHMARK.json only gained entries
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path
