"""What decides ``correct``: the program's outputs held against the plain
reference of the configuration's family (``reference/<family>.py``, around
:mod:`portbench.reference.attack`), computed again from the seed's inputs
in float32.

An attack cell records the first three steps of the window's last epoch,
as ``AttackRunner.train_epoch`` drove them. The reference follows them from
the program's own ``p`` before each step, and the start is checked by
itself: the reference draws the initial ``p`` again and projects it. The
numbers, each the worst over the steps:

* ``p0_rel``: ``‖p0 − p0_ref‖ / ‖p0_ref‖``, the start;
* ``loss_rel``: the batch's CTC sum against the reference's, relative;
* ``logit_gap``: the widest gap by which the logit of a greedy id the
  program emitted lies below the reference's best at that row and frame;
* ``sign_miss``: the share of ``Σ|g_ref|`` where the sign of the program's
  step differs from the reference gradient's. The program's step is read
  from its new ``p``: the projection scales the STFT by one factor, so
  ``p_new ≈ c·(p + lr·s)`` and ``s = sign(p_new − c·p)`` with the
  reference's factor ``c``;
* ``step_rel``: ``‖p_new − p_new_ref‖ / ‖p_new_ref − p‖``, where
  ``p_new_ref`` is the reference's sign step and projection from the same
  ``p``; a step that leaves ``p`` as it was reads 1.

An eval cell checks a sample of the window's batches: positions in the
pass drawn from the seed, each as the window's last pass scored it;
``loss_rel`` and ``logit_gap`` as above, with ``p`` the reference's own
start.

A batch's rows are found from its audio: the first samples of each row of
the batch the program was given are looked up in the benchmark's own clips,
and the reference reads those clips. A row that matches no clip fails the
check.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench import family, inputs
from portbench.reference import attack as ref

HEAD = 16  # samples of each row that identify its clip


class Record(NamedTuple):
    """One call of the program's step, as it returned."""

    p_in: torch.Tensor | None
    p_out: torch.Tensor | None
    loss: torch.Tensor
    ids: torch.Tensor
    heads: torch.Tensor  # (B, HEAD) first samples of each row
    weights: torch.Tensor
    lr: float | None


def record_train(step, keep: list, n: int, per_epoch: int):
    """``step`` (the runner's train step) that also keeps, in ``keep``, the
    first ``n`` calls of the latest epoch of ``per_epoch`` calls."""
    calls = 0

    def wrapped(p, opt_state, audio, labels, pads, weights, cparams, lr):
        nonlocal calls
        new_p, new_opt, m = step(p, opt_state, audio, labels, pads, weights, cparams, lr)
        position = calls % per_epoch
        calls += 1
        if position == 0:
            keep.clear()
        if position < n:
            keep.append(Record(p.detach().clone(), new_p.detach().clone(), m.ctc_loss,
                               m.greedy_ids, audio[:, :HEAD].clone(), weights.clone(),
                               float(lr)))
        return new_p, new_opt, m
    return wrapped


def record_eval(step, keep: dict, positions: list, per_pass: int):
    """``step`` (the runner's eval step) that also keeps, for each batch
    position of a pass in ``positions``, its latest call in ``keep``."""
    calls = 0

    def wrapped(p, audio, labels, pads, weights):
        nonlocal calls
        m = step(p, audio, labels, pads, weights)
        position = calls % per_pass
        calls += 1
        if position in positions:
            keep[position] = Record(None, None, m.ctc_loss, m.greedy_ids,
                                    audio[:, :HEAD].clone(), weights.clone(), None)
        return m
    return wrapped


def _geometry(traffic: dict) -> ref.Geometry:
    s = traffic["stft"]
    return ref.Geometry(traffic["sample_rate"], s["n_fft"], s["hop"], s["win"])


def _batch(rec: Record, clips: inputs.Clips, dev):
    rows = inputs.rows_of(rec.heads.cpu().numpy(), clips.audio)
    if (rows < 0).any():
        return None
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(clips.audio[rows]), t(clips.labels[rows]), t(clips.lengths[rows])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _params(cfg: dict, seed: int, dev) -> dict:
    """The seed's weights again, as float32."""
    return {k: v.float() for k, v in inputs.weights(cfg, seed, dev).items()}


def attack_numbers(records: list, p0: torch.Tensor, clips: inputs.Clips, cfg: dict,
                   traffic: dict, seed: int, dev, rows: int) -> dict:
    """The attack cell's numbers (module docstring); ``p0`` is the program's
    start."""
    model, params = family.reference(cfg), _params(cfg, seed, dev)
    geom = _geometry(traffic)
    tab = ref.tables(geom, dev)
    eps = traffic["fm_epsilon"]
    p0_ref = ref.initial_p(seed, clips.audio.shape[1], eps, geom, tab, dev)
    out = {"p0_rel": _rel(p0, p0_ref), "loss_rel": 0.0, "logit_gap": 0.0,
           "sign_miss": 0.0, "step_rel": 0.0}
    for rec in records:
        batch = _batch(rec, clips, dev)
        if batch is None:
            return {k: math.inf for k in out}
        audio, labels, lengths = batch
        res = ref.run_batch(model, params, cfg, audio, labels, lengths, rec.weights.float(),
                            rec.p_in, rec.ids, rows, grad=True, clamp=True)
        stepped = ref.sign_step(rec.p_in, res.grad, rec.lr)
        p_ref = ref.project(stepped, eps, geom, tab)
        c = float(torch.dot(p_ref.flatten(), stepped.flatten()) / torch.dot(
            stepped.flatten(), stepped.flatten()))
        s_prog = torch.sign(rec.p_out - c * rec.p_in)
        g = res.grad.abs()
        miss = float(g[s_prog != torch.sign(res.grad)].sum() / g.sum())
        out["loss_rel"] = max(out["loss_rel"], abs(float(rec.loss) - res.loss) / abs(res.loss))
        out["logit_gap"] = max(out["logit_gap"], res.logit_gap)
        out["sign_miss"] = max(out["sign_miss"], miss)
        step = torch.linalg.vector_norm(p_ref - rec.p_in)
        out["step_rel"] = max(out["step_rel"],
                              float(torch.linalg.vector_norm(rec.p_out - p_ref) / step))
        del res, audio
    return out


def eval_positions(batches_per_pass: int, k: int, seed: int) -> list:
    """``k`` distinct batch positions of a pass, drawn from the seed: the
    batches checked, each from the last pass of the window."""
    rng = np.random.default_rng([seed, 17])
    return sorted(int(b) for b in rng.choice(batches_per_pass, size=min(k, batches_per_pass),
                                             replace=False))


def eval_numbers(records: list, clips: inputs.Clips, cfg: dict, traffic: dict, seed: int,
                 dev, rows: int) -> dict:
    """The eval cell's numbers over the recorded calls (module docstring)."""
    model, params = family.reference(cfg), _params(cfg, seed, dev)
    geom = _geometry(traffic)
    p = ref.initial_p(seed, clips.audio.shape[1], traffic["fm_epsilon"], geom,
                      ref.tables(geom, dev), dev)
    out = {"loss_rel": 0.0, "logit_gap": 0.0}
    for rec in records:
        batch = _batch(rec, clips, dev)
        if batch is None:
            return {k: math.inf for k in out}
        audio, labels, lengths = batch
        res = ref.run_batch(model, params, cfg, audio, labels, lengths, rec.weights.float(), p,
                            rec.ids, rows, grad=False, clamp=False)
        out["loss_rel"] = max(out["loss_rel"], abs(float(rec.loss) - res.loss) / abs(res.loss))
        out["logit_gap"] = max(out["logit_gap"], res.logit_gap)
    return out


def control_records(records: list, clips: inputs.Clips, cfg: dict, traffic: dict, seed: int,
                    dev, rows: int) -> list:
    """The control in the program's place: for each recorded call, the
    family's reference computed in fp8 (its ``Precision("fp8")``) on the
    same rows and the same ``p`` gives the loss, the greedy ids and, for a
    train step, the new ``p`` (its sign step and projection)."""
    model, params = family.reference(cfg), _params(cfg, seed, dev)
    prec = model.Precision("fp8")
    geom = _geometry(traffic)
    tab = ref.tables(geom, dev)
    eps = traffic["fm_epsilon"]
    p_eval = ref.initial_p(seed, clips.audio.shape[1], eps, geom, tab, dev)
    out = []
    for rec in records:
        audio, labels, lengths = _batch(rec, clips, dev)
        train = rec.p_in is not None
        res = ref.run_batch(model, params, cfg, audio, labels, lengths, rec.weights.float(),
                            rec.p_in if train else p_eval, None, rows, grad=train,
                            clamp=train, prec=prec)
        p_out = ref.project(ref.sign_step(rec.p_in, res.grad, rec.lr), eps, geom,
                            tab) if train else None
        out.append(rec._replace(p_out=p_out, loss=torch.tensor(res.loss), ids=res.ids))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {value, limit}})``: every number finite and at or
    under its limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
