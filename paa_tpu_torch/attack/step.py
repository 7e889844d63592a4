"""The attack step: one training iteration, and the eval step.

Port of ``paa_tpu/attack/step.py``. A train step composes and clamps
``audio + p``, runs the frozen model, takes the weighted CTC sum, the
gradient with respect to ``p`` only (summed over ``accum_steps``
microbatches), the optimizer update and the projection. The eval step adds
``p`` *without* clamping, as the reference's evaluation does.

Every step takes the global batch. On a mesh (``parallel/mesh.py``) with a
``data`` axis each rank runs the model on its rows (``pipeline.shard_rows``)
and the collectives XLA inserts for the reference's sharded steps are
written out: the summed CTC loss and ∂loss/∂p are all-reduced over
``data``, the greedy ids gathered into global row order. The update and
the projection then run replicated on every rank, on the global batch (the
``snr`` and ``tv`` balls are sized from the whole clean batch, as XLA's
global reduction sizes them), so every rank ends with the same bits of p.
On a ``model`` axis the model itself holds the Megatron collectives
(``parallel/tp.py``), and ∂loss/∂p is taken from the first rank of each
model slice.

The ε-sweep step has the reference's two forms. On a mesh whose ``sweep``
axis is 1 (one device, or ``_ns_for`` gives 1) it is host-multiplexed: S
single-cell steps per shared batch, one cell's activations alive at a time,
each over the mesh's data axis. With one sweep slice per cell it is
sharded: each slice trains its own cell on its data axis, and each cell's
new state and metrics are broadcast from the first rank of its slice, so
every rank returns every cell.

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
from paa_tpu_torch.data import pipeline
from paa_tpu_torch.ops import ctc, projections
from paa_tpu_torch.ops.psycho import PsychoTables
from paa_tpu_torch.parallel import mesh as mesh_lib


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


def _local(mesh, batch):
    """This rank's rows of every array of ``batch`` on the mesh's data axis."""
    n, r = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    return [pipeline.shard_rows(x, n, r) for x in batch]


def _grad_fn(model, cfg: AttackConfig, mesh) -> Callable:
    """``(p, audio, labels, label_paddings, weights) -> (loss, ids, grad)``
    over the global batch: on one device directly; on a mesh with a data
    axis from this rank's rows, the loss and gradient summed and the ids
    gathered over ``data``. On a ``model`` axis every rank of a slice
    computes the replicated layers' backward itself, and cuDNN's backward
    convolutions need not give the same bits twice: the slice takes its
    first rank's gradient, so that every rank's p keeps the same bits."""
    if mesh is None or (mesh.shape.get("data", 1) == 1 and mesh.shape.get("model", 1) == 1):
        return lambda p, *batch: _grad_and_metrics(model, cfg, p, *batch)

    def grad_fn(p, *batch):
        loss, ids, grad = _grad_and_metrics(model, cfg, p, *_local(mesh, batch))
        grad = mesh.broadcast(grad, "model")
        return (mesh.all_reduce(loss, "data"), mesh.gather_rows(ids),
                mesh.all_reduce(grad, "data"))

    return grad_fn


def _eval_fn(model, mesh) -> Callable:
    """``(p, audio, labels, label_paddings, weights) -> StepMetrics`` over
    the global batch, ``p`` added unclamped; on a mesh with a data axis from
    this rank's rows, as :func:`_grad_fn`."""

    @torch.no_grad()
    def metrics(p, audio, labels, label_paddings, weights):
        logits = model(audio + p)
        per_example = ctc.ctc_loss(logits, labels, label_paddings, reduction="none")
        return StepMetrics(ctc_loss=torch.sum(per_example * weights),
                           greedy_ids=ctc.greedy_ids(logits))

    if mesh is None or mesh.shape.get("data", 1) == 1:
        return metrics

    def eval_fn(p, *batch):
        m = metrics(p, *_local(mesh, batch))
        return StepMetrics(mesh.all_reduce(m.ctc_loss, "data"), mesh.gather_rows(m.greedy_ids))

    return eval_fn


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


def make_sharded_step(cfg: AttackConfig, model: torch.nn.Module, tables: PsychoTables,
                      mesh) -> Callable:
    """Train step over ``mesh`` (None: one device)
    ``(p, opt_state, audio, labels, label_paddings, weights, cparams, lr)
    -> (new_p, new_opt_state, StepMetrics)`` on the global batch; the
    metrics are global on every rank. The model is frozen; on a mesh with a
    ``model`` axis it is this rank's shard (``tp.shard_model``)."""
    model.requires_grad_(False).eval()
    grad_fn = _grad_fn(model, cfg, mesh)

    def train_step(p, opt_state, audio, labels, label_paddings, weights,
                   cparams: ConstraintParams, lr):
        loss, greedy, grad = grad_fn(p, audio, labels, label_paddings, weights)
        new_p, new_opt_state = _cell_mask_update(cfg, tables, audio, p, grad, opt_state,
                                                 cparams, True, lr)
        return new_p, new_opt_state, StepMetrics(ctc_loss=loss, greedy_ids=greedy)

    return train_step


def make_train_step(cfg: AttackConfig, model: torch.nn.Module, tables: PsychoTables) -> Callable:
    """One-device train step
    ``(p, opt_state, audio, labels, label_paddings, weights, cparams, lr)
    -> (new_p, new_opt_state, StepMetrics)``. The model is frozen."""
    return make_sharded_step(cfg, model, tables, None)


def make_sharded_eval_step(cfg: AttackConfig, model: torch.nn.Module, mesh) -> Callable:
    """Eval step over ``mesh`` (None: one device)
    ``(p, audio, labels, label_paddings, weights) -> StepMetrics``: loss and
    greedy ids of the global batch with ``p`` added but not clamped."""
    model.requires_grad_(False).eval()
    return _eval_fn(model, mesh)


def make_eval_step(cfg: AttackConfig, model: torch.nn.Module) -> Callable:
    """One-device eval step ``(p, audio, labels, label_paddings, weights) ->
    StepMetrics``: loss and greedy ids with ``p`` added but not clamped."""
    return make_sharded_eval_step(cfg, model, None)


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


def _leaves(tree) -> list:
    if tree is None:
        return []
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _from_owners(mesh, mine: int, trees: list):
    """Every cell's ``trees`` on every rank: cell ``s``'s from the first rank
    of sweep slice ``s``, which computed it (broadcasts keep the bits,
    -0.0 included). ``trees`` are this rank's cell-``mine`` values; the
    result stacks each along a new leading cell axis."""
    S, n_data = mesh.shape["sweep"], mesh.shape["data"]
    out = []
    for tree in trees:
        leaves = _leaves(tree)
        stacked = [torch.empty((S,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                   for x in leaves]
        for s in range(S):
            for buf, x in zip(stacked, leaves):
                if s == mine:
                    buf[s] = x
                mesh_lib.broadcast(buf[s], src=s * n_data)
        if tree is None or isinstance(tree, torch.Tensor):
            out.append(stacked[0] if stacked else None)
        else:
            out.append(type(tree)(*stacked))
    return out


def make_sweep_step(cfg: AttackConfig, model: torch.nn.Module, tables: PsychoTables,
                    mesh=None) -> Callable:
    """ε-sweep train step
    ``(p_s, opt_state_s, audio, labels, label_paddings, weights, cparams_s,
    active_s, lr) -> (new_p_s, new_opt_state_s, StepMetrics)``. ``p_s`` is
    (S, 1, T); the optimizer state and ``cparams_s`` lead with the cell
    axis; ``active_s`` is a host array of S 0/1 values. A frozen cell is
    still scored (its loss and greedy ids), but its p and optimizer state
    come back bit for bit (reference: ``paa_tpu/attack/step.py:237-422``).
    Metrics stack along the cell axis: ``ctc_loss`` (S,), ``greedy_ids``
    (S, B, frames).

    ``mesh`` is a ``(sweep, data)`` mesh, or None for one device. With a
    sweep axis of 1 the train step's body runs once per cell on the shared
    batch over the data axis (the multiplexed form); with S sweep slices
    each rank trains the cell of its slice and every rank returns all of
    them.

    The sweep driver drops a frozen cell from the state as soon as the
    multiplexed form runs on both sides of the drop
    (``cli/sweep.py:_should_drop``); the sharded form keeps it, frozen, by
    the mask."""
    model.requires_grad_(False).eval()
    grad_fn = _grad_fn(model, cfg, mesh)

    def one_cell(p, opt_state, batch, cparams, active, lr):
        loss, greedy, grad = grad_fn(p, *batch)
        new_p, new_opt = _cell_mask_update(cfg, tables, batch[0], p, grad, opt_state,
                                           cparams, active, lr)
        return new_p, new_opt, loss, greedy

    if mesh is not None and mesh.shape["sweep"] > 1:
        mine = mesh.coords["sweep"]

        def sharded_sweep_step(p_s, opt_state_s, audio, labels, label_paddings, weights,
                               cparams_s: ConstraintParams, active_s, lr):
            if p_s.shape[0] != mesh.shape["sweep"]:
                raise ValueError(f"{p_s.shape[0]} cells on a sweep axis of {mesh.shape['sweep']}")
            active = np.asarray(active_s) > 0.5
            new_p, new_opt, loss, greedy = one_cell(
                p_s[mine], cell(opt_state_s, mine), (audio, labels, label_paddings, weights),
                cell(cparams_s, mine), bool(active[mine]), lr)
            new_p, new_opt, losses, ids = _from_owners(mesh, mine, [new_p, new_opt, loss, greedy])
            return new_p, new_opt, StepMetrics(ctc_loss=losses, greedy_ids=ids)

        return sharded_sweep_step

    def sweep_step(p_s, opt_state_s, audio, labels, label_paddings, weights,
                   cparams_s: ConstraintParams, active_s, lr):
        active = np.asarray(active_s) > 0.5
        new_p, new_opt, losses, ids = [], [], [], []
        for i in range(p_s.shape[0]):
            np_i, no_i, loss, greedy = one_cell(
                p_s[i], cell(opt_state_s, i), (audio, labels, label_paddings, weights),
                cell(cparams_s, i), bool(active[i]), lr)
            new_p.append(np_i)
            new_opt.append(no_i)
            losses.append(loss)
            ids.append(greedy)
        return (torch.stack(new_p), stack_cells(new_opt),
                StepMetrics(ctc_loss=torch.stack(losses), greedy_ids=torch.stack(ids)))

    return sweep_step


def make_sweep_eval_step(cfg: AttackConfig, model: torch.nn.Module, mesh=None) -> Callable:
    """ε-sweep eval step ``(p_s, audio, labels, label_paddings, weights) ->
    StepMetrics`` stacked along the cell axis, ``p`` added unclamped: the
    eval step once per cell (sweep axis 1, over the data axis), or each
    sweep slice scoring its own cell (reference:
    ``paa_tpu/attack/step.py:385-422``)."""
    model.requires_grad_(False).eval()
    eval_fn = _eval_fn(model, mesh)

    if mesh is not None and mesh.shape["sweep"] > 1:
        mine = mesh.coords["sweep"]

        def sharded_sweep_eval(p_s, audio, labels, label_paddings, weights):
            m = eval_fn(p_s[mine], audio, labels, label_paddings, weights)
            losses, ids = _from_owners(mesh, mine, [m.ctc_loss, m.greedy_ids])
            return StepMetrics(ctc_loss=losses, greedy_ids=ids)

        return sharded_sweep_eval

    def sweep_eval(p_s, audio, labels, label_paddings, weights):
        ms = [eval_fn(p, audio, labels, label_paddings, weights) for p in p_s]
        return StepMetrics(ctc_loss=torch.stack([m.ctc_loss for m in ms]),
                           greedy_ids=torch.stack([m.greedy_ids for m in ms]))

    return sweep_eval
