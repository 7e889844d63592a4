"""The port's config and weight converter against the JAX package, and the
port's freedom from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.models import convert as jconvert
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu_torch import config as tcfg
from paa_tpu_torch.models import convert as tconvert
from paa_tpu_torch.models import wav2vec2 as tw2v

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_attack_config_fields_and_defaults_match():
    want = [(f.name, f.default) for f in dataclasses.fields(jcfg.AttackConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tcfg.AttackConfig)]
    assert got == want
    for name in ("NORM_TYPES", "FREQ_NORM_TYPES", "ATTACK_MODES", "OPTIMIZER_TYPES"):
        assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("kw", [dict(norm_type="nope"), dict(attack_mode="x"),
                                dict(optimizer_type="sgd"), dict(tp=0)])
def test_attack_config_rejects_what_the_reference_rejects(kw):
    for cls in (jcfg.AttackConfig, tcfg.AttackConfig):
        with pytest.raises(ValueError):
            cls(**kw)


def test_constraint_params_defaults_match():
    want = jcfg.ConstraintParams.create()
    got = tcfg.ConstraintParams.create()
    assert got._fields == want._fields
    for name in want._fields:
        assert getattr(got, name).dtype == torch.float32
        assert float(getattr(got, name)) == float(getattr(want, name)), name


@pytest.mark.parametrize("preset", ["wav2vec2-tiny", "wav2vec2-base", "wav2vec2-large-lv60"])
def test_params_from_jax_matches_export_hf_state_dict(preset):
    jc = jw2v.get_config(preset, num_hidden_layers=2)
    params = jw2v.init_params(jc, example_len=2000)
    want = jconvert.export_hf_state_dict(params, jc)
    tc = tw2v.get_config(preset, num_hidden_layers=2)
    got = tconvert.params_from_jax(params, tc)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port's module takes it with no converter and no key left over
    tw2v.Wav2Vec2ForCTC(tc).load_state_dict(got, strict=True)


def test_model_presets_match_reference_geometry():
    """Every field of the port's config has the reference's value, but
    ``remat_feature_extractor``: off in the port, on in the reference (the
    port's config says why)."""
    for name in ("wav2vec2-tiny", "wav2vec2-base", "wav2vec2-large-lv60"):
        j, t = jw2v.get_config(name), tw2v.get_config(name)
        for f in dataclasses.fields(tw2v.Wav2Vec2Config):
            if f.name == "remat_feature_extractor":
                assert (t.remat_feature_extractor, j.remat_feature_extractor) == (False, True)
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        for n in (4000, 16000, 160000):
            assert t.feat_extract_output_length(n) == j.feat_extract_output_length(n)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paa_tpu_torch\n"
        "for m in pkgutil.walk_packages(paa_tpu_torch.__path__, 'paa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'paa_tpu' or m.startswith('paa_tpu.'))\n"
        "assert not ref, ref\n"
        "need = {'paa_tpu_torch.cli.run_attack', 'paa_tpu_torch.cli.parser',\n"
        "        'paa_tpu_torch.train.loop', 'paa_tpu_torch.train.checkpoint',\n"
        "        'paa_tpu_torch.data.pipeline', 'paa_tpu_torch.cli.sweep',\n"
        "        'paa_tpu_torch.cli.aggregate', 'paa_tpu_torch.cli.launch_grid',\n"
        "        'paa_tpu_torch.train.pretrain'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('paa_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 24  # every module of the package was imported


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; alone in
    a directory, without the package, it fails too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    script = os.path.join(REPO, "chip_smoke.py")
    here = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(script).read())
    there = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=120)
    assert there.returncode != 0 and '"ok"' not in there.stdout
