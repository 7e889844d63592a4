"""The port's ``run_attack`` against the JAX package's on snr and tv, from
one initial p, on the device feed in float32 on the CPU.

The same A/B as ``tools/f3_ab.py`` at a small size: the committed tiny
checkpoint on 48 synthetic clips, B=8, seed 5, Adam at lr 1e-4, 2 epochs,
snr 50 and tv 1e-3 (the round-5 cells), each started from the JAX runner's
own initial perturbation (``jax.random`` with the run seed, projected once
against the first train batch). With the initial p and the compute dtype
the same, the two packages must give the same run: every epoch's scores
within 1e-4 relative (CTC) and 0.03 (WER, the tolerance stated for the two
packages' perturbed test WER on these cells), the same best epoch and test
scores. The final perturbations agree within 1e-3 of their largest sample
on 99.9 % of the samples: Adam moves each sample by about lr a step whatever
the gradient's size, so where a gradient is near 0 the two packages' float32
sums may take opposite signs, and such a sample ends up to 2·lr a step apart.
"""

import json
import os

import numpy as np
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.data import datasets
from paa_tpu.data import pipeline as jpipe
from paa_tpu.models import checkpoint_io
from paa_tpu.models import convert as jconvert
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu.train import loop as jloop
from paa_tpu_torch import config as tcfg
from paa_tpu_torch.data import pipeline as tpipe
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")
CELLS = {"snr": {"snr_db": 50.0}, "tv": {"tv_epsilon": 1e-3}}
CTC_REL, WER_ABS, P_REL, P_SHARE = 1e-4, 0.03, 1e-3, 0.999


@pytest.fixture(scope="module")
def bundle():
    sd = checkpoint_io.load_safetensors(TINY_CKPT)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.requires_grad_(False).eval()
    jc = jw2v.get_config("wav2vec2-tiny")
    jm = jw2v.Wav2Vec2ForCTC(jc)
    japply = lambda prm, a: jm.apply({"params": prm}, a)
    samples = datasets.load_dataset_tuples("synthetic", synthetic_samples=48)
    jp, tp = jpipe.build_pipeline(samples, seed=5), tpipe.build_pipeline(samples, seed=5)
    return model, japply, jconvert.convert_hf_state_dict(sd, jc), jp, tp


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("norm", list(CELLS))
def test_run_attack_matches_jax_from_one_initial_p(bundle, norm, tmp_path):
    model, japply, jparams, jp, tp = bundle
    kw = dict(norm_type=norm, optimizer_type="adam", lr=1e-4, batch_size=8, num_epochs=2,
              early_stopping=4, seed=5, model_name="wav2vec2-tiny", compute_dtype="float32",
              cache_data_on_device=True)
    jc, tc = jcfg.AttackConfig(**kw), tcfg.AttackConfig(**kw)
    jparams_c = jcfg.ConstraintParams.create(**CELLS[norm])
    runner = jloop.AttackRunner(jc, japply, jparams, jp, cparams=jparams_c, use_mesh=False)
    p0 = np.asarray(runner.init_perturbation(jc.seed), np.float32)

    want = jloop.run_attack(jc, japply, jparams, jp, str(tmp_path / "jax"), cparams=jparams_c,
                            num_items_to_inspect=0, resume=False, init_p=p0)
    got = loop.run_attack(tc, model, tp, str(tmp_path / "port"),
                          cparams=tcfg.ConstraintParams.create(**CELLS[norm]),
                          num_items_to_inspect=0, resume=False, init_p=p0)

    jm, tm = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert len(tm) == len(jm) == 2
    for a, b in zip(tm, jm):
        for key in ("train_ctc", "eval_clean_ctc", "eval_pert_ctc"):
            assert a[key] == pytest.approx(b[key], rel=CTC_REL), (a["epoch"], key)
        for key in ("train_wer", "eval_clean_wer", "eval_pert_wer"):
            assert abs(a[key] - b[key]) <= WER_ABS, (a["epoch"], key)
    assert got.best_epoch == want.best_epoch
    for split in ("test_clean", "test_perturbed"):
        g, w = getattr(got, split), getattr(want, split)
        assert g.ctc == pytest.approx(w.ctc, rel=CTC_REL), split
        assert abs(g.wer - w.wer) <= WER_ABS, split
    p_got, p_want = np.asarray(got.perturbation), np.asarray(want.perturbation)
    scale = float(np.abs(p_want).max())
    diff = np.abs(p_got - p_want)
    assert float((diff <= P_REL * scale).mean()) >= P_SHARE
    steps = kw["num_epochs"] * -(-len(tp.train) // kw["batch_size"])
    assert float(diff.max()) <= 2 * kw["lr"] * steps
    # the run moved p: the comparison is not of two copies of p0
    assert float((np.abs(p_want - p0) > P_REL * scale).mean()) > 0.5
