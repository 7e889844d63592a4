"""One attack step of the port against paa_tpu.attack.step, tiny model in
float32 on the CPU, from the same p."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.attack import optimizers as jopt
from paa_tpu.attack import step as jstep
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu.ops import psycho as jpsycho
from paa_tpu.ops import text
from paa_tpu_torch import config as tcfg
from paa_tpu_torch.attack import optimizers as topt
from paa_tpu_torch.attack import step as tstep
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.ops import psycho as tpsycho

T = 8000
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jc = jw2v.get_config("wav2vec2-tiny")
    params = jw2v.init_params(jc, seed=2, example_len=2000)
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    japply = lambda prm, a: jmodel.apply({"params": prm}, a)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict(convert.params_from_jax(params, model.cfg))
    rng = np.random.default_rng(11)
    audio = (rng.standard_normal((3, T)) * 0.3).astype(np.float32)
    audio[0, :100] = 1.5  # clamped samples
    labels, pads = text.encode_batch(["hello world", "delete", "test tone"])
    weights = np.array([1.0, 1.0, 0.0], np.float32)  # a padding row
    p = (rng.standard_normal((1, T)) * 1e-3).astype(np.float32)
    return params, japply, model, audio, labels, pads, weights, p


def _run(setup, norm, opt, steps):
    params, japply, model, audio, labels, pads, weights, p = setup
    jc = jcfg.AttackConfig(norm_type=norm, optimizer_type=opt, lr=LR)
    tc = tcfg.AttackConfig(norm_type=norm, optimizer_type=opt, lr=LR)
    jtrain = jstep.make_train_step(jc, japply, jpsycho.build_tables(jc))
    ttrain = tstep.make_train_step(tc, model, tpsycho.build_tables(tc))
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    jst, tst = jopt.init_opt_state(jc, jp), topt.init_opt_state(tc, tp)
    out = []
    j_args = [jnp.asarray(a) for a in (audio, labels, pads, weights)]
    t_args = [torch.from_numpy(a) for a in (audio, labels, pads, weights)]
    for _ in range(steps):
        jp, jst, jm = jtrain(params, jp, jst, *j_args, jcfg.ConstraintParams.create(),
                             jnp.float32(LR))
        tp, tst, tm = ttrain(tp, tst, *t_args, tcfg.ConstraintParams.create(), LR)
        out.append((jm, tm))
    return jp, jst, tp, tst, out


def test_gradient_wrt_p_matches_jax(setup):
    """∂loss/∂p through clamp, model and weighted CTC sum: signs agree
    (PGD's input; signs near 0 may flip) and values agree closely."""
    params, japply, model, audio, labels, pads, weights, p = setup
    cfg = jcfg.AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd")
    jloss, jids, jgrad = jstep._grad_and_metrics(
        jnp.asarray(p), *(jnp.asarray(a) for a in (audio, labels, pads, weights)),
        japply, params, cfg)
    tloss, tids, tgrad = tstep._grad_and_metrics(
        model, tcfg.AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd"),
        *(torch.from_numpy(a) for a in (p, audio, labels, pads, weights)))
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert np.mean(np.sign(tgrad.numpy()) == np.sign(jgrad)) >= 0.99
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-3 * np.abs(jgrad).max())


@pytest.mark.parametrize("norm", ["fletcher_munson", "linf"])
def test_pgd_step_matches_jax(setup, norm):
    jp, _, tp, _, [(jm, tm)] = _run(setup, norm, "pgd", 1)
    np.testing.assert_allclose(float(tm.ctc_loss), float(jm.ctc_loss), rtol=1e-4)
    np.testing.assert_array_equal(tm.greedy_ids.numpy(), np.asarray(jm.greedy_ids))
    # a PGD step moves each sample by ±lr; a gradient sign that flips near 0
    # moves it by 2·lr, so at least 99% of the samples must agree closely
    diff = np.abs(tp.numpy() - np.asarray(jp))
    assert np.mean(diff < 1e-2 * LR) >= 0.99
    assert diff.max() <= 2 * LR * 1.01


def test_adam_steps_match_jax(setup):
    jp, jst, tp, tst, out = _run(setup, "l2", "adam", 2)
    for jm, tm in out:
        np.testing.assert_allclose(float(tm.ctc_loss), float(jm.ctc_loss), rtol=1e-4)
    inner = jst.inner  # optax.ScaleByAdamState
    assert int(tst.count) == int(inner.count) == 2
    scale = np.abs(np.asarray(inner.mu)).max()
    np.testing.assert_allclose(tst.mu.numpy(), np.asarray(inner.mu), atol=1e-3 * scale)
    np.testing.assert_allclose(tst.nu.numpy(), np.asarray(inner.nu), rtol=2e-3,
                               atol=1e-3 * np.abs(np.asarray(inner.nu)).max())
    # an Adam update is near ±lr wherever |grad| ≫ eps, so, as with PGD, a
    # gradient near 0 can move a sample by up to 2·lr per step
    diff = np.abs(tp.numpy() - np.asarray(jp))
    assert np.mean(diff < 1e-2 * LR) >= 0.99
    assert diff.max() <= 2 * 2 * LR * 1.01


def test_eval_step_matches_jax_without_clamp(setup):
    params, japply, model, audio, labels, pads, weights, p = setup
    jeval = jstep.make_eval_step(jcfg.AttackConfig(), japply)
    teval = tstep.make_eval_step(tcfg.AttackConfig(), model)
    jm = jeval(params, jnp.asarray(p), *(jnp.asarray(a) for a in (audio, labels, pads, weights)))
    tm = teval(torch.from_numpy(p), *(torch.from_numpy(a) for a in (audio, labels, pads, weights)))
    np.testing.assert_allclose(float(tm.ctc_loss), float(jm.ctc_loss), rtol=1e-4)
    np.testing.assert_array_equal(tm.greedy_ids.numpy(), np.asarray(jm.greedy_ids))


def test_step_lr_matches():
    c = tcfg.AttackConfig()
    for epoch in range(7):
        assert topt.step_lr(c, epoch) == jopt.step_lr(jcfg.AttackConfig(), epoch)


def test_accum_steps_not_ported_yet(setup):
    """accum_steps is ported; what stays refused is a batch that A does not
    divide (3 rows at A=2), as in the reference."""
    params, japply, model, audio, labels, pads, weights, p = setup
    cfg = tcfg.AttackConfig(accum_steps=2, norm_type="linf", optimizer_type="pgd")
    train = tstep.make_train_step(cfg, model, tpsycho.build_tables(cfg))
    with pytest.raises(ValueError, match="not divisible by accum_steps 2"):
        train(torch.from_numpy(p), None, *(torch.from_numpy(a) for a in (audio, labels, pads, weights)),
              tcfg.ConstraintParams.create(), LR)


@pytest.fixture(scope="module")
def lv60_setup():
    """The lv60-flag tiny model (conv bias, LayerNorm FE, pre-LN, do_normalize)
    in both packages, and a batch of 4 rows with a padding row."""
    flags = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
                 do_normalize=True)
    jc = jw2v.get_config("wav2vec2-tiny", **flags)
    params = jw2v.init_params(jc, seed=4, example_len=2000)
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    japply = lambda prm, a: jmodel.apply({"params": prm}, a)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny", **flags))
    model.load_state_dict(convert.params_from_jax(params, model.cfg))
    rng = np.random.default_rng(12)
    audio = (rng.standard_normal((4, T)) * 0.3).astype(np.float32)
    labels, pads = text.encode_batch(["hello world", "delete", "test tone", "open close"])
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    p = (rng.standard_normal((1, T)) * 1e-3).astype(np.float32)
    return params, japply, model, audio, labels, pads, weights, p


def test_accum_steps_2_equals_one_pass(lv60_setup):
    """A=2 against A=1 in the port: the same loss and greedy ids, and the
    gradient within f32 rounding of a sum in another order (1e-5 of its
    largest value)."""
    _, _, model, audio, labels, pads, weights, p = lv60_setup
    args = [torch.from_numpy(a) for a in (p, audio, labels, pads, weights)]
    out = {A: tstep._grad_and_metrics(model, tcfg.AttackConfig(accum_steps=A), *args)
           for A in (1, 2)}
    (l1, ids1, g1), (l2, ids2, g2) = out[1], out[2]
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    np.testing.assert_array_equal(ids2.numpy(), ids1.numpy())
    assert ids2.shape == (4, tw2v.get_config("wav2vec2-tiny").feat_extract_output_length(T))
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), atol=1e-5 * float(g1.abs().max()))


def test_accum_steps_2_pgd_step_matches_jax(lv60_setup):
    """The port at A=2 against paa_tpu's make_train_step at A=2 on the
    lv60-flag tiny model, fletcher_munson PGD: loss within 1e-4, greedy ids
    equal, and the new p within the PGD tolerance of the base test (99 % of
    the samples within 1 % of lr; none beyond a flipped sign, 2·lr)."""
    params, japply, model, audio, labels, pads, weights, p = lv60_setup
    kw = dict(norm_type="fletcher_munson", optimizer_type="pgd", lr=LR, accum_steps=2)
    jc, tc = jcfg.AttackConfig(**kw), tcfg.AttackConfig(**kw)
    jtrain = jstep.make_train_step(jc, japply, jpsycho.build_tables(jc))
    ttrain = tstep.make_train_step(tc, model, tpsycho.build_tables(tc))
    jp, _, jm = jtrain(params, jnp.asarray(p), None,
                       *(jnp.asarray(a) for a in (audio, labels, pads, weights)),
                       jcfg.ConstraintParams.create(), jnp.float32(LR))
    tp, _, tm = ttrain(torch.from_numpy(p), None,
                       *(torch.from_numpy(a) for a in (audio, labels, pads, weights)),
                       tcfg.ConstraintParams.create(), LR)
    np.testing.assert_allclose(float(tm.ctc_loss), float(jm.ctc_loss), rtol=1e-4)
    np.testing.assert_array_equal(tm.greedy_ids.numpy(), np.asarray(jm.greedy_ids))
    diff = np.abs(tp.numpy() - np.asarray(jp))
    assert np.mean(diff < 1e-2 * LR) >= 0.99
    assert diff.max() <= 2 * LR * 1.01
