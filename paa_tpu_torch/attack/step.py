"""The attack step: one training iteration, and the eval step.

Port of ``paa_tpu/attack/step.py:35-168``. A train step composes and clamps
``audio + p``, runs the frozen model, takes the weighted CTC sum, the
gradient with respect to ``p`` only (summed over ``accum_steps``
microbatches), the optimizer update and the projection. The eval step adds ``p`` *without* clamping, as the reference's
evaluation does.

The ε-sweep train step is the reference's host-multiplexed form
(``paa_tpu/attack/step.py:237-304``): S single-cell steps per shared batch,
one cell's activations alive at a time. Its sweep eval is the single-cell
eval step once per cell, which the sweep driver runs through
``AttackRunner.evaluate``. The vmapped and sharded forms need more than one
device and are not ported (ROADMAP.md, queue 1: dp/tp); on one device the
reference picks the multiplexed form too.

The JAX steps take the model parameters as an argument; here the frozen
``nn.Module`` holds them, so the step functions take everything else in the
same order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from paa_tpu_torch.attack import optimizers
from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.ops import ctc, projections
from paa_tpu_torch.ops.psycho import PsychoTables


class StepMetrics(NamedTuple):
    ctc_loss: torch.Tensor  # scalar, 'sum' reduction weighted over the batch
    greedy_ids: torch.Tensor  # (B, frames) int32 argmax ids


def _microbatch(model, cfg: AttackConfig, p, audio, labels, label_paddings, weights):
    p = p.detach().requires_grad_(True)
    perturbed = audio + p
    if cfg.clamp_audio:
        perturbed = torch.clamp(perturbed, -1.0, 1.0)
    logits = model(perturbed)
    per_example = ctc.ctc_loss(logits, labels, label_paddings, reduction="none")
    loss = torch.sum(per_example * weights)
    (grad,) = torch.autograd.grad(loss, p)
    return loss.detach(), ctc.greedy_ids(logits.detach()), grad


def _grad_and_metrics(model, cfg: AttackConfig, p, audio, labels, label_paddings, weights):
    """``(loss, greedy_ids, ∂loss/∂p)``.

    With ``cfg.accum_steps = A > 1`` the batch runs as A microbatches of
    B/A rows, in order, and their losses and gradients are summed; the
    'sum' CTC reduction is linear in the batch, so this is the one-pass
    result with a microbatch's activation memory (reference:
    ``paa_tpu/attack/step.py:72-104``)."""
    A = cfg.accum_steps
    if A <= 1:
        return _microbatch(model, cfg, p, audio, labels, label_paddings, weights)
    B = audio.shape[0]
    if B % A:
        raise ValueError(f"batch size {B} not divisible by accum_steps {A}")
    n = B // A
    loss, grad, ids = None, None, []
    for i in range(A):
        rows = slice(i * n, (i + 1) * n)
        l, g_ids, g = _microbatch(model, cfg, p, audio[rows], labels[rows],
                                  label_paddings[rows], weights[rows])
        loss = l if loss is None else loss + l
        grad = g if grad is None else grad + g
        ids.append(g_ids)
    return loss, torch.cat(ids), grad


def _cell_mask_update(cfg, tables, audio, p, grad, opt_state, cparams, active: bool, lr):
    """Optimizer update, projection and early-stop freeze of one cell: a
    frozen cell (``active`` false) keeps its p and optimizer state as they
    are (reference: ``paa_tpu/attack/step.py:237-246``, where ``active`` is
    a traced 0/1 mask; here the host knows it)."""
    if not active:
        return p, opt_state
    with torch.no_grad():
        new_p, new_opt_state = optimizers.apply_update(cfg, p, grad, opt_state, lr)
        new_p = projections.perturbation_constraint(new_p, audio, cfg, cparams, tables)
    return new_p, new_opt_state


def make_train_step(cfg: AttackConfig, model: torch.nn.Module, tables: PsychoTables) -> Callable:
    """Train step
    ``(p, opt_state, audio, labels, label_paddings, weights, cparams, lr)
    -> (new_p, new_opt_state, StepMetrics)``. The model is frozen."""
    if cfg.tp > 1:
        raise NotImplementedError("tp > 1 is not ported yet (ROADMAP.md, queue 1: dp/tp)")
    model.requires_grad_(False).eval()

    def train_step(p, opt_state, audio, labels, label_paddings, weights,
                   cparams: ConstraintParams, lr):
        loss, greedy, grad = _grad_and_metrics(
            model, cfg, p, audio, labels, label_paddings, weights)
        new_p, new_opt_state = _cell_mask_update(cfg, tables, audio, p, grad, opt_state,
                                                 cparams, True, lr)
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


def cell(tree, i: int):
    """Cell ``i`` of a per-cell state: p_s, an ``AdamState`` or
    ``ConstraintParams`` whose leaves lead with the cell axis, or None."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree[i]
    return type(tree)(*(x[i] for x in tree))


def stack_cells(trees: list):
    """The inverse of :func:`cell`: stack per-cell states along a new
    leading cell axis."""
    if trees[0] is None or isinstance(trees[0], torch.Tensor):
        return None if trees[0] is None else torch.stack(trees)
    return type(trees[0])(*(torch.stack(xs) for xs in zip(*trees)))


def make_sweep_step(cfg: AttackConfig, model: torch.nn.Module, tables: PsychoTables) -> Callable:
    """ε-sweep train step
    ``(p_s, opt_state_s, audio, labels, label_paddings, weights, cparams_s,
    active_s, lr) -> (new_p_s, new_opt_state_s, StepMetrics)``: the train
    step's body once per cell on the shared batch, so only one cell's
    activations are alive at a time. ``p_s`` is (S, 1, T); the optimizer
    state and ``cparams_s`` lead with the cell axis; ``active_s`` is a host
    array of S 0/1 values. A frozen cell is still scored (its loss and
    greedy ids), but its p and optimizer state come back bit for bit
    (reference: ``paa_tpu/attack/step.py:249-304``). Metrics stack along the
    cell axis: ``ctc_loss`` (S,), ``greedy_ids`` (S, B, frames).

    The one-device sweep driver never passes a 0: it drops a frozen cell
    from the state before the next epoch (``cli/sweep.py:_should_drop``),
    so a frozen cell would only pay a forward and backward for scores it
    throws away. The mask is kept for the reference's signature."""
    if cfg.tp > 1:
        raise NotImplementedError("tp > 1 is not ported yet (ROADMAP.md, queue 1: dp/tp)")
    model.requires_grad_(False).eval()

    def sweep_step(p_s, opt_state_s, audio, labels, label_paddings, weights,
                   cparams_s: ConstraintParams, active_s, lr):
        active = np.asarray(active_s) > 0.5
        new_p, new_opt, losses, ids = [], [], [], []
        for i in range(p_s.shape[0]):
            p_i = p_s[i]
            loss, greedy, grad = _grad_and_metrics(
                model, cfg, p_i, audio, labels, label_paddings, weights)
            np_i, no_i = _cell_mask_update(cfg, tables, audio, p_i, grad, cell(opt_state_s, i),
                                           cell(cparams_s, i), bool(active[i]), lr)
            new_p.append(np_i)
            new_opt.append(no_i)
            losses.append(loss)
            ids.append(greedy)
        return (torch.stack(new_p), stack_cells(new_opt),
                StepMetrics(ctc_loss=torch.stack(losses), greedy_ids=torch.stack(ids)))

    return sweep_step

