"""The port's victim pretraining (paa_tpu_torch.train.pretrain) and HF-layout
export against paa_tpu.train.pretrain and paa_tpu.models.convert: the
config, optax's schedule, clip and Adam, the loss and every parameter
gradient, whole steps, the held-out evaluation, the export, and the
command line (float32, CPU)."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paa_tpu.data import datasets as jdatasets, pipeline as jpipeline
from paa_tpu.models import checkpoint_io as jckpt
from paa_tpu.models import convert as jconvert
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu.ops import ctc as jctc
from paa_tpu.train import pretrain as jpretrain
from paa_tpu_torch.data import datasets as tdatasets, pipeline as tpipeline
from paa_tpu_torch.models import checkpoint_io as tckpt
from paa_tpu_torch.models import convert as tconvert
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.ops import ctc as tctc
from paa_tpu_torch.train import pretrain as tpretrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")

# the lv60 layout on the tiny widths (tests/test_pretrain.py's export case)
LV60_LAYOUT = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True)


def _cfg(**kw) -> tuple:
    return jpretrain.PretrainConfig(**kw), tpretrain.PretrainConfig(**kw)


def _randomize_affine(params, seed):
    """Biases N(0, 0.1) and norm scales 1 + N(0, 0.1). With zero conv
    biases the lv60 layout's first LayerNorm normalises a one-channel conv,
    a sign function of the input whose bias gradients reach 1e19."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name in ("bias", "conv_bias"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.1
        if name == "scale":
            return 1.0 + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return np.array(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(layout: dict, seed: int = 1):
    """(JAX config, JAX params, the port's model on the same weights)."""
    jc = jw2v.get_config("wav2vec2-tiny", **layout)
    params = jw2v.init_params(jc, seed=seed, example_len=2000)
    if layout:
        params = _randomize_affine(params, seed + 1)
    tc = tw2v.get_config("wav2vec2-tiny", **layout)
    model = tw2v.Wav2Vec2ForCTC(tc)
    model.load_state_dict(tconvert.params_from_jax(params, tc))
    return jc, jax.tree.map(np.asarray, params), model


def _batch(n: int = 24, seed: int = 7, batch_size: int = 4):
    """One training batch of the synthetic corpus (the JAX feed's), clips of
    3-4 words."""
    samples = jdatasets.load_dataset_tuples("synthetic", seed=seed, synthetic_samples=n,
                                            synthetic_words=(3, 4))
    pipe = jpipeline.build_pipeline(samples, seed=seed)
    return next(pipe.train.batches(batch_size))


def _torch(batch):
    return tuple(torch.from_numpy(np.asarray(a))
                 for a in (batch.audio, batch.labels, batch.label_paddings))


def _jax_loss(jc):
    model = jw2v.Wav2Vec2ForCTC(jc)

    def loss(params, audio, labels, pads):
        return jctc.ctc_loss(model.apply({"params": params}, audio), labels, pads,
                             reduction="mean")

    return loss


def test_pretrain_config_fields_and_defaults_match():
    want = [(f.name, f.default) for f in dataclasses.fields(jpretrain.PretrainConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tpretrain.PretrainConfig)]
    assert got == want


@pytest.mark.parametrize("steps, warmup", [(20, 5), (3, 5), (5, 5), (10, 0), (4000, 300)])
def test_schedule_matches_optax(steps, warmup):
    """At every count 0..steps+5, steps < warmup + 1 included; count 0 is 0."""
    jc, tc = _cfg(steps=steps, warmup_steps=warmup, lr=1e-3)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=jc.lr, warmup_steps=jc.warmup_steps,
        decay_steps=max(jc.steps, jc.warmup_steps + 1), end_value=jc.lr * 0.1)
    # make_optimizer's own schedule is this one: its first update is 0
    counts = range(steps + 6)
    got = np.array([tpretrain.learning_rate(tc, c) for c in counts])
    np.testing.assert_allclose(got, [float(want(c)) for c in counts], rtol=1e-6, atol=0)
    assert got[0] == 0.0 or warmup == 0


def _grads(seed: int, scale: float) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 5), (7,), (2, 2, 4))]


@pytest.mark.parametrize("scale", [1e-3, 0.2, 1.0, 30.0])
def test_clip_matches_optax(scale):
    """Norms below 1 pass unchanged; above, every leaf scales by 1/‖g‖."""
    grads = _grads(0, scale)
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = tpretrain.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if norm < 1.0:
            assert np.array_equal(g.numpy(), orig)


def test_optimizer_matches_optax_over_five_updates():
    """make_optimizer's chain on the same gradients: the first update has
    lr 0 and leaves the parameters bit for bit; 1e-6 after five."""
    jc, tc = _cfg(steps=10, warmup_steps=2, lr=1e-2)
    p0 = _grads(1, 1.0)
    tx = jpretrain.make_optimizer(jc)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in p0]
    tstate = tpretrain.init_opt_state(tparams)
    for i in range(5):
        grads = _grads(10 + i, [0.3, 5.0, 0.01, 2.0, 0.5][i])
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = tpretrain.apply_update(tc, tparams, [torch.from_numpy(g) for g in grads], tstate)
        if i == 0:
            for t, p in zip(tparams, p0):
                assert np.array_equal(t.numpy(), p)
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    assert tstate.count == 5


# Gradient tolerance: rtol 1e-4 plus an atol of 1e-4 of the tensor's largest
# gradient and 1e-6 of the largest gradient overall. Against a float64
# evaluation of the same model and batch (tools/grad_precision_torch.py), the
# JAX package's own float32 gradients sit up to 1.5e-5 of a tensor's largest
# value away, the port's up to 4.3e-5 (lv60 layout), and the two differ by at
# most 3.5e-5 on that scale, in a few elements of the feature extractor whose
# own value is small. The k_proj biases have an analytic gradient of 0
# (softmax ignores a shift of every key): both packages return rounding
# noise there, which the atol of the largest gradient overall covers.
GRAD_TOL = {"rtol": 1e-4, "atol_tensor": 1e-4, "atol_global": 1e-6}


@pytest.mark.parametrize("layout", [{}, LV60_LAYOUT, dict(remat_ffn=True),
                                    dict(LV60_LAYOUT, remat_ffn=True)],
                         ids=["tiny", "lv60_layout", "tiny_remat_ffn", "lv60_layout_remat_ffn"])
def test_loss_and_every_gradient_match_jax(layout):
    """Mean CTC and the gradient of every parameter, the weight-norm gain
    and direction and (lv60 layout) the feature extractor's LayerNorms
    included, within ``GRAD_TOL``; with ``remat_ffn`` the FFN's weight
    gradients come from ``_FFNFn``'s backward (JAX's from ``_ffn``'s)."""
    jc, params, model = _pair(layout)
    batch = _batch()
    audio, labels, pads = _torch(batch)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jc)))(params, jnp.asarray(batch.audio),
                                               jnp.asarray(batch.labels),
                                               jnp.asarray(batch.label_paddings))
    model.requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    loss = tctc.ctc_loss(model(audio), labels, pads, reduction="mean")
    grads = torch.autograd.grad(loss, leaves)
    want = tconvert.params_from_jax(jax.tree.map(np.asarray, jg), model.cfg)
    assert set(names) == set(want)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    g_max = max(float(w.abs().max()) for w in want.values())
    for name, g in zip(names, grads):
        w = want[name].numpy()
        atol = GRAD_TOL["atol_tensor"] * np.abs(w).max() + GRAD_TOL["atol_global"] * g_max
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL["rtol"], atol=atol, err_msg=name)


# Three steps from the same weights, warmup 2 (learning rates 0, lr/2, lr).
# Step 1 leaves the weights bit for bit. Adam then divides each element's
# gradient by its own scale, so an element whose gradient is near 0 (the
# k_proj biases are rounding noise) can move by up to its learning rate
# either way; measured on this batch: max 0.029·lr, 99.92 % of elements
# within 1e-6 and 99.997 % within 1e-5 after step 3, losses within 3.9e-6.
STEP_TOL = {"loss_rtol": 1e-4, "param_max_lr": 0.1, "share_1e-6": 0.998, "share_1e-5": 0.9995}


def test_three_steps_match_jax():
    jc_model, params, model = _pair({}, seed=3)
    jc, tc = _cfg(steps=10, warmup_steps=2, lr=1e-3)
    tx = jpretrain.make_optimizer(jc)
    jstep = jpretrain.make_pretrain_step(jw2v.Wav2Vec2ForCTC(jc_model), tx)
    jstate = tx.init(params)
    tstep = tpretrain.make_pretrain_step(model, tc)
    tstate = tpretrain.init_opt_state(list(model.parameters()))
    batch = _batch(seed=9)
    jparams = params
    start = tconvert.params_from_jax(params, model.cfg)
    for i in range(3):
        jparams, jstate, jl = jstep(jparams, jstate, batch.audio, jnp.asarray(batch.labels),
                                    jnp.asarray(batch.label_paddings))
        tstate, tl = tstep(tstate, *_torch(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_TOL["loss_rtol"])
        want = tconvert.params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg)
        got = model.state_dict()
        if i == 0:  # lr 0: bit for bit the initial weights
            assert all(torch.equal(got[k], start[k]) for k in start)
        diff = np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in want])
        assert diff.max() <= STEP_TOL["param_max_lr"] * tc.lr, diff.max()
        assert (diff <= 1e-6).mean() >= STEP_TOL["share_1e-6"]
        assert (diff <= 1e-5).mean() >= STEP_TOL["share_1e-5"]
    assert tstate.count == 3


def test_evaluate_wer_matches_jax():
    """The committed checkpoint on a held-out split: WER equal, CTC 1e-4."""
    samples = tdatasets.load_dataset_tuples("synthetic", seed=5, synthetic_samples=160)
    tpipe = tpipeline.build_pipeline(samples, seed=5)
    jsamples = jdatasets.load_dataset_tuples("synthetic", seed=5, synthetic_samples=160)
    jpipe = jpipeline.build_pipeline(jsamples, seed=5)
    sd = jckpt.load_state_dict(TINY_CKPT)
    jc = jw2v.get_config("wav2vec2-tiny")
    jparams = jax.tree.map(np.asarray, jconvert.convert_hf_state_dict(sd, jc))
    want_wer, want_ctc = jpretrain.evaluate_wer(
        jpretrain.make_logits_fn(jw2v.Wav2Vec2ForCTC(jc)), jparams, jpipe.eval, 8)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got_wer, got_ctc = tpretrain.evaluate_wer(tpretrain.make_logits_fn(model), tpipe.eval, 8)
    assert got_wer == want_wer
    assert 0.0 < got_wer < 1.0
    np.testing.assert_allclose(got_ctc, want_ctc, rtol=1e-4)


def test_committed_checkpoint_gives_its_recorded_eval_wer():
    """The committed checkpoint on its own corpus (seed 5, 2048 clips, B=32)
    through the port's evaluate_wer: the eval WER its history records,
    the same error count, and its eval CTC within 1e-5."""
    with open(os.path.splitext(TINY_CKPT)[0] + ".history.json") as f:
        record = json.load(f)
    cfg = record["config"]
    samples = tdatasets.load_dataset_tuples("synthetic", seed=cfg["seed"],
                                            synthetic_samples=cfg["synthetic_samples"])
    pipe = tpipeline.build_pipeline(samples, seed=cfg["seed"])
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config(cfg["model"]))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in tckpt.load_state_dict(TINY_CKPT).items()})
    wer, ctc = tpretrain.evaluate_wer(tpretrain.make_logits_fn(model), pipe.eval,
                                      cfg["batch_size"])
    assert wer == record["history"]["best_eval_wer"]
    np.testing.assert_allclose(ctc, record["history"]["eval_ctc"][-1], rtol=1e-5)


@pytest.mark.parametrize("layout", [{}, LV60_LAYOUT], ids=["tiny", "lv60_layout"])
def test_export_is_bit_equal_to_jax_and_converts_back(layout, tmp_path):
    jc, params, model = _pair(layout, seed=4)
    want = jconvert.export_hf_state_dict(params, jc)
    got = tconvert.export_hf_state_dict(model.state_dict())
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = jconvert.convert_hf_state_dict(got, jc)
    same = jax.tree.map(lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
                        params, back)
    assert all(jax.tree.leaves(same))
    # through the file: the JAX package's reader sees the same tensors
    out = str(tmp_path / "model.safetensors")
    tpretrain.export_checkpoint(model.state_dict(), out)
    read = jckpt.load_state_dict(out)
    assert set(read) == set(want)
    assert all(np.array_equal(read[k], want[k]) for k in want)


def test_export_drops_masked_spec_embed():
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    sd = {**model.state_dict(), "wav2vec2.masked_spec_embed": torch.zeros(64)}
    assert set(tconvert.export_hf_state_dict(sd)) == set(model.state_dict())


def test_forty_steps_reduce_the_loss_and_export_round_trips(tmp_path):
    """As tests/test_pretrain.py's smoke run: 40 steps on a micro corpus
    materially reduce the CTC loss; the best weights are a host copy, and
    the exported file reproduces the held-out WER exactly."""
    samples = tdatasets.load_dataset_tuples("synthetic", seed=7, synthetic_samples=48)
    pipe = tpipeline.build_pipeline(samples, seed=7)
    cfg = tpretrain.PretrainConfig(steps=40, batch_size=8, lr=1e-3, warmup_steps=10,
                                   eval_every=20, synthetic_samples=48, seed=7)
    losses, models = [], []

    def watch(step, model, loss):
        losses.append(float(loss))
        models.append(model)

    best, history = tpretrain.pretrain(cfg, pipe=pipe, device="cpu", on_step=watch)
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert losses[-1] < 0.6 * losses[0], losses[:3] + losses[-3:]
    assert history["loss"] == [losses[0]] and history["eval_step"] == [20, 40]
    live = dict(models[-1].state_dict())
    assert all(best[k].data_ptr() != live[k].data_ptr() for k in best)
    want_keys = {"step", "loss", "eval_step", "eval_wer", "eval_ctc", "best_eval_wer",
                 "test_wer", "test_ctc", "wall_sec"}
    assert set(history) == want_keys

    out = str(tmp_path / "model.safetensors")
    tpretrain.export_checkpoint(best, out)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in tckpt.load_state_dict(out).items()})
    wer, _ = tpretrain.evaluate_wer(tpretrain.make_logits_fn(model), pipe.test, cfg.batch_size)
    assert wer == history["test_wer"]


def _flags(help_text: str) -> set[str]:
    return set(re.findall(r"--\w+", help_text))


def test_cli_flags_are_the_jax_packages(capsys):
    for main in (jpretrain.main, tpretrain.main):
        with pytest.raises(SystemExit):
            main(["--help"])
    jhelp, thelp = capsys.readouterr().out.split("usage:")[1:]
    assert _flags(thelp) == _flags(jhelp)


def test_cli_runs_on_the_cpu_and_writes_the_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "ckpt" / "model.safetensors"
    code = tpretrain.main(["--platform", "cpu", "--steps", "3", "--eval_every", "2",
                           "--batch_size", "8", "--synthetic_samples", "48", "--seed", "7",
                           "--out", str(out)])
    assert code == 0
    sd = tckpt.load_state_dict(str(out))
    assert set(sd) == set(tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny")).state_dict())
    record = json.loads((tmp_path / "ckpt" / "model.history.json").read_text())
    assert record["config"] == dataclasses.asdict(tpretrain.PretrainConfig(
        steps=3, eval_every=2, batch_size=8, synthetic_samples=48, seed=7))
    assert record["history"]["eval_step"] == [2, 3]
    assert set(record["history"]) == {"step", "loss", "eval_step", "eval_wer", "eval_ctc",
                                      "best_eval_wer", "test_wer", "test_ctc", "wall_sec"}


def test_cli_never_writes_the_committed_checkpoint(capsys):
    assert os.path.abspath(os.path.join(REPO, tpretrain.DEFAULT_OUT)) != TINY_CKPT
    assert tpretrain.REFERENCE_CHECKPOINT == TINY_CKPT
    with pytest.raises(SystemExit) as e:
        tpretrain.main(["--platform", "cpu", "--out", TINY_CKPT])
    assert e.value.code == 2 and "committed checkpoint" in capsys.readouterr().err


def test_cli_refuses_device_probe_timeout(capsys):
    with pytest.raises(SystemExit) as e:
        tpretrain.main(["--platform", "cpu", "--device_probe_timeout", "20"])
    assert e.value.code == 2 and "--device_probe_timeout" in capsys.readouterr().err


def test_cli_default_platform_without_a_gpu_fails(tmp_path):
    """``python -m paa_tpu_torch.train.pretrain`` runs on the card by default;
    with no CUDA device it exits non-zero and writes nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "model.safetensors"
    run = subprocess.run([sys.executable, "-m", "paa_tpu_torch.train.pretrain", "--steps", "1",
                          "--out", str(out)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr
    assert not out.exists()
