"""The plain reference against the program at a tiny size in float32 on the
CPU: logits, the CTC loss, ∂loss/∂p, the new p after the sign step and the
projection, and the psychoacoustic tables. The test imports both; the
reference itself imports nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paa_tpu_torch.attack import step as program_step
from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.ops import ctc as program_ctc
from paa_tpu_torch.ops import projections, psycho
from portbench import family, inputs, system
from portbench.reference import attack as ref
from portbench.tests import tiny

GEOM = ref.Geometry(16000, 1024, 256, 1024)


def _setup(name: str, seed: int = 3):
    cfg = tiny.config(name)
    cfg["assumed"] = {**cfg["assumed"], "compute_dtype": "float32", "param_storage": "float32"}
    weights = inputs.weights(cfg, seed, torch.device("cpu"))
    params = {k: v.float() for k, v in weights.items()}
    model = family.program(cfg).build_model(cfg, params, torch.device("cpu"))
    clips = inputs.clips(seed, 1, 3, 16000, (2, 3), 0.1, torch.device("cpu"))
    audio = torch.from_numpy(clips.audio)
    return cfg, params, model, clips, audio


@pytest.mark.parametrize("name", ["wav2vec2-base", "wav2vec2-large-lv60"])
def test_logits_loss_and_gradient(name):
    cfg, params, model, clips, audio = _setup(name)
    p = 1e-3 * torch.randn((1, audio.shape[1]), generator=torch.Generator().manual_seed(1))
    labels = torch.from_numpy(clips.labels)
    pads = torch.from_numpy(clips.paddings)
    weights = torch.ones(3)
    with torch.no_grad():
        got = model(audio + p)
        want = family.reference(cfg).forward(params, cfg, audio + p)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), float((got - want).abs().max())
    acfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", batch_size=3)
    loss, ids, grad = program_step._grad_and_metrics(model, acfg, p, audio, labels, pads,
                                                     weights)
    res = ref.run_batch(family.reference(cfg), params, cfg, audio, labels,
                        torch.from_numpy(clips.lengths), weights, p, ids, rows=2, grad=True,
                        clamp=True)
    assert abs(float(loss) - res.loss) <= 1e-4 * abs(res.loss)
    assert res.logit_gap <= 1e-4
    assert torch.equal(res.ids, program_ctc.greedy_ids(want))
    assert float((grad - res.grad).norm() / res.grad.norm()) < 1e-3


def test_tables_and_projection():
    acfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd")
    tables = psycho.build_tables(acfg)
    tab = ref.tables(GEOM, "cpu")
    np.testing.assert_allclose(tab.weight.numpy(), tables.fm_table.numpy(), atol=1e-7)
    np.testing.assert_array_equal(tab.in_domain.numpy(), tables.fm_in_domain.numpy())
    raw = torch.randn((1, 16000), generator=torch.Generator().manual_seed(8))
    cparams = ConstraintParams.create()
    got = projections.perturbation_constraint(raw, None, acfg, cparams, tables)
    want = ref.project(raw, 2.0, GEOM, tab)
    assert float((got - want).norm() / want.norm()) < 1e-6
    stepped = ref.sign_step(want, torch.randn_like(want), 1e-4)
    got = projections.perturbation_constraint(stepped, None, acfg, cparams, tables)
    assert float((got - ref.project(stepped, 2.0, GEOM, tab)).norm() / got.norm()) < 1e-6


def test_initial_p_is_the_runners():
    cfg, params, model, clips, _ = _setup("wav2vec2-base")
    cell = tiny.cell("wav2vec2-base", "attack")
    runner = system.build_runner(cfg, cell["traffic"], params, clips, None, torch.device("cpu"))
    got = runner.init_perturbation(2**31 + 5)
    want = ref.initial_p(2**31 + 5, 16000, 2.0, GEOM, ref.tables(GEOM, "cpu"), "cpu")
    assert float((got - want).norm() / want.norm()) < 1e-6
