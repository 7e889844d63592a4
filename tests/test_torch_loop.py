"""The port's attack loop against paa_tpu.train.loop (tests/test_loop.py's
cases), on the committed tiny checkpoint in float32, 48 synthetic clips,
from the same initial perturbation."""

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
from paa_tpu_torch.train import checkpoint, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")


@pytest.fixture(scope="module")
def bundle():
    sd = checkpoint_io.load_safetensors(TINY_CKPT)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.requires_grad_(False).eval()
    samples = datasets.load_dataset_tuples("synthetic", synthetic_samples=48)
    return sd, model, samples, tpipe.build_pipeline(samples, seed=5)


def _kw(**over):
    kw = dict(norm_type="fletcher_munson", optimizer_type="pgd", lr=5e-3, batch_size=8,
              num_epochs=2, early_stopping=4, seed=5, model_name="wav2vec2-tiny")
    kw.update(over)
    return kw


def _init_p(audio_len):
    return (np.random.default_rng(21).standard_normal((1, audio_len)) * 1e-3).astype(np.float32)


def test_run_attack_matches_jax(tmp_path, bundle):
    """Two epochs of fletcher_munson PGD from the same init_p. The clean
    scores depend on no step: within 1e-4 relative. The attacked scores
    follow 8 sign steps, where a gradient sign near 0 may flip: CTC within
    2 % relative, WER within 0.05."""
    sd, model, samples, pipe = bundle
    init_p = _init_p(pipe.audio_len)
    jc = jw2v.get_config("wav2vec2-tiny")
    japply = lambda prm, a, m=jw2v.Wav2Vec2ForCTC(jc): m.apply({"params": prm}, a)
    jres = jloop.run_attack(
        jcfg.AttackConfig(**_kw()), japply, jconvert.convert_hf_state_dict(sd, jc),
        jpipe.build_pipeline(samples, seed=5), str(tmp_path / "jax"),
        num_items_to_inspect=0, init_p=init_p)
    tres = loop.run_attack(tcfg.AttackConfig(**_kw()), model, pipe, str(tmp_path / "port"),
                           num_items_to_inspect=2, init_p=init_p)
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    got = json.loads((tmp_path / "port" / "results.json").read_text())
    assert got["finished_training"] is True and got["best_epoch"] == want["best_epoch"]
    for metric in ("ctc", "wer"):
        assert got["eval_score_clean"][metric] == pytest.approx(
            want["eval_score_clean"][metric], rel=1e-4, abs=1e-4)
    assert got["eval_score_perturbed"]["ctc"] == pytest.approx(
        want["eval_score_perturbed"]["ctc"], rel=2e-2)
    assert abs(got["eval_score_perturbed"]["wer"] - want["eval_score_perturbed"]["wer"]) <= 0.05
    np.testing.assert_allclose(tres.history["eval_clean_ctc"], jres.history["eval_clean_ctc"],
                               rtol=1e-4)
    # the port's artifact bundle
    for f in ("results.json", "perturbation.npy", "perturbation.wav", "perturbation_5x.wav",
              checkpoint.STATE_FILE, "metrics.jsonl"):
        assert (tmp_path / "port" / f).exists(), f
    assert any("sample_" in d for d in os.listdir(tmp_path / "port"))
    lines = [json.loads(line) for line in open(tmp_path / "port" / "metrics.jsonl")]
    assert [line["epoch"] for line in lines] == [0, 1]
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "perturbation.npy"),
                                  tres.perturbation)


def test_resume_is_exact(tmp_path, bundle):
    """1 epoch, then resumed to 3, equals 3 epochs straight, bit for bit,
    with Adam (its moments and count are in the checkpoint)."""
    _, model, _, pipe = bundle
    kw = dict(cparams=tcfg.ConstraintParams.create(fm_epsilon=4.0), num_items_to_inspect=0,
              init_p=_init_p(pipe.audio_len))
    cfg = lambda n: tcfg.AttackConfig(**_kw(optimizer_type="adam", lr=1e-3, num_epochs=n,
                                            early_stopping=99))
    straight = loop.run_attack(cfg(3), model, pipe, str(tmp_path / "straight"), **kw)
    loop.run_attack(cfg(1), model, pipe, str(tmp_path / "resumed"), **kw)
    resumed = loop.run_attack(cfg(3), model, pipe, str(tmp_path / "resumed"), resume=True, **kw)
    np.testing.assert_array_equal(resumed.perturbation, straight.perturbation)
    assert resumed.history == straight.history
    lines = [json.loads(line) for line in open(tmp_path / "resumed" / "metrics.jsonl")]
    assert [line["epoch"] for line in lines] == [0, 1, 2]


def test_early_stopping(tmp_path, bundle):
    """linf at lr = 0 (a projection that leaves p where it is): nothing
    improves after epoch 0, so the run stops after the patience, not after
    10 epochs."""
    _, model, _, pipe = bundle
    res = loop.run_attack(
        tcfg.AttackConfig(**_kw(norm_type="linf", lr=0.0, num_epochs=10, early_stopping=2)),
        model, pipe, str(tmp_path), cparams=tcfg.ConstraintParams.create(linf_size=0.02),
        num_items_to_inspect=0)
    assert len(res.history["train_ctc"]) <= 4


def test_targeted_mode_runs(tmp_path, bundle):
    """target_reps=8 needs more label slots than the corpus allocated: the
    targeted label grid widens; the emission metrics are recorded."""
    _, model, _, pipe = bundle
    res = loop.run_attack(
        tcfg.AttackConfig(**_kw(attack_mode="targeted", target="delete", target_reps=8,
                                num_epochs=1)),
        model, pipe, str(tmp_path), num_items_to_inspect=0)
    assert np.isfinite(res.test_perturbed.ctc)
    assert len(res.history["eval_emission_rate"]) == 1
    assert "targeted_metrics" in json.loads((tmp_path / "results.json").read_text())


def test_targeted_labels_match_jax_and_infeasible_raises(bundle):
    pipe = bundle[3]
    kw = _kw(attack_mode="targeted", target="delete", target_reps=3)
    want = jloop._targeted_labels(jcfg.AttackConfig(**kw), 8, 16, audio_len=pipe.audio_len)
    got = loop._targeted_labels(tcfg.AttackConfig(**kw), 8, 16, audio_len=pipe.audio_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="target_reps"):
        loop._targeted_labels(tcfg.AttackConfig(**_kw(attack_mode="targeted", target_reps=100)),
                              8, 16, audio_len=pipe.audio_len)


def test_init_perturbation_is_seeded_and_projected(bundle):
    """The port draws the initial p from a seeded CPU generator (JAX's
    PRNG is not reproducible in torch) and projects it into the ball."""
    _, model, _, pipe = bundle
    runner = loop.AttackRunner(tcfg.AttackConfig(**_kw(norm_type="linf")), model, pipe,
                               tcfg.ConstraintParams.create(linf_size=0.01))
    a, b = runner.init_perturbation(7), runner.init_perturbation(7)
    assert a.shape == (1, pipe.audio_len)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.abs().max()) == pytest.approx(0.01)
    assert not torch.equal(a, runner.init_perturbation(8))


def test_checkpoint_history_drift_tolerated(tmp_path):
    """A checkpoint written before a history series existed still loads:
    the missing series NaN-fills to the surviving length, a series the
    template no longer names disappears."""
    old = {
        "p": np.zeros((1, 4), np.float32), "epoch": 2,
        "history": {"train_ctc": np.asarray([1.0, 2.0, 3.0]),
                    "legacy_series": np.asarray([9.0, 9.0, 9.0])},
    }
    path = os.path.join(tmp_path, checkpoint.STATE_FILE)
    checkpoint.save_checkpoint(path, old)
    assert checkpoint.discover_resume(str(tmp_path)) == (True, path)
    template = {"history": {"train_ctc": [], "eval_emission_rate": []}}
    state = checkpoint.load_checkpoint(path, template)
    assert int(state["epoch"]) == 2
    np.testing.assert_array_equal(state["history"]["train_ctc"].numpy(), [1.0, 2.0, 3.0])
    assert "legacy_series" not in state["history"]
    em = state["history"]["eval_emission_rate"].numpy()
    assert em.shape == (3,) and np.all(np.isnan(em))
    assert checkpoint.discover_resume(str(tmp_path / "elsewhere")) == (False, None)
