"""The attack step: one training iteration, and the eval step.

Port of ``paa_tpu/attack/step.py:35-168``. A train step composes and clamps
``audio + p``, runs the frozen model, takes the weighted CTC sum, the
gradient with respect to ``p`` only, the optimizer update and the
projection. The eval step adds ``p`` *without* clamping, as the reference's
evaluation does.

The JAX steps take the model parameters as an argument; here the frozen
``nn.Module`` holds them, so the step functions take everything else in the
same order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from paa_tpu_torch.attack import optimizers
from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.ops import ctc, projections
from paa_tpu_torch.ops.psycho import PsychoTables


class StepMetrics(NamedTuple):
    ctc_loss: torch.Tensor  # scalar, 'sum' reduction weighted over the batch
    greedy_ids: torch.Tensor  # (B, frames) int32 argmax ids


def _grad_and_metrics(model, cfg: AttackConfig, p, audio, labels, label_paddings, weights):
    """``(loss, greedy_ids, ∂loss/∂p)``."""
    p = p.detach().requires_grad_(True)
    perturbed = audio + p
    if cfg.clamp_audio:
        perturbed = torch.clamp(perturbed, -1.0, 1.0)
    logits = model(perturbed)
    per_example = ctc.ctc_loss(logits, labels, label_paddings, reduction="none")
    loss = torch.sum(per_example * weights)
    (grad,) = torch.autograd.grad(loss, p)
    return loss.detach(), ctc.greedy_ids(logits.detach()), grad


def make_train_step(cfg: AttackConfig, model: torch.nn.Module, tables: PsychoTables) -> Callable:
    """Train step
    ``(p, opt_state, audio, labels, label_paddings, weights, cparams, lr)
    -> (new_p, new_opt_state, StepMetrics)``. The model is frozen."""
    if cfg.accum_steps > 1:
        raise NotImplementedError(
            "accum_steps > 1 is not ported yet (ROADMAP.md, queue 1: accum_steps)")
    if cfg.tp > 1:
        raise NotImplementedError("tp > 1 is not ported yet (ROADMAP.md, queue 1: dp/tp)")
    model.requires_grad_(False).eval()

    def train_step(p, opt_state, audio, labels, label_paddings, weights,
                   cparams: ConstraintParams, lr):
        loss, greedy, grad = _grad_and_metrics(
            model, cfg, p, audio, labels, label_paddings, weights)
        with torch.no_grad():
            new_p, new_opt_state = optimizers.apply_update(cfg, p, grad, opt_state, lr)
            new_p = projections.perturbation_constraint(new_p, audio, cfg, cparams, tables)
        return new_p, new_opt_state, StepMetrics(ctc_loss=loss, greedy_ids=greedy)

    return train_step


def make_eval_step(cfg: AttackConfig, model: torch.nn.Module) -> Callable:
    """Eval step ``(p, audio, labels, label_paddings, weights) -> StepMetrics``:
    loss and greedy ids with ``p`` added but not clamped."""
    model.requires_grad_(False).eval()

    @torch.no_grad()
    def eval_step(p, audio, labels, label_paddings, weights):
        logits = model(audio + p)
        per_example = ctc.ctc_loss(logits, labels, label_paddings, reduction="none")
        return StepMetrics(ctc_loss=torch.sum(per_example * weights),
                           greedy_ids=ctc.greedy_ids(logits))

    return eval_step
