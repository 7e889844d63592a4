"""Faults planted in the program for the check's own tests and readings.

Each is a context manager that replaces one function of the program's
modules for the duration of the block (the source is never edited), so
that the timed path runs broken underneath the harness:

* ``unchanged_state``: the train step returns ``p`` and the optimizer
  state as they came;
* ``half_batch``: the step runs on the first half of the batch's rows and
  doubles the loss and the gradient (the mean over the rest, scaled to the
  batch); the left-out rows get the kept rows' greedy ids;
* ``altered_token``: every tenth frame's greedy id is replaced by the
  frame's least likely token where the ids are produced;
* ``k3_norm_high``: the Fletcher-Munson norm (kernel K3) reads 10 % high,
  so every projection, the start's included, scales ``p`` too far.

Plant a fault before the runner is built: the eval step is made then.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, fn):
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def unchanged_state():
    from paa_tpu_torch.attack import step

    return _patched(step, "_cell_mask_update",
                    lambda _f: lambda cfg, tables, audio, p, grad, opt_state, *rest:
                    (p, opt_state))


def _halves(batch: tuple) -> tuple:
    n = batch[0].shape[0] // 2
    return tuple(x[:n] for x in batch)


def half_batch():
    from paa_tpu_torch.attack import step

    stack = contextlib.ExitStack()

    def grad_and_metrics(original):
        def fn(model, cfg, p, *batch):
            loss, ids, grad = original(model, cfg, p, *_halves(batch))
            return 2.0 * loss, torch.cat([ids, ids]), 2.0 * grad
        return fn

    def eval_fn(original):
        def make(model, mesh):
            inner = original(model, mesh)

            def fn(p, *batch):
                m = inner(p, *_halves(batch))
                return step.StepMetrics(2.0 * m.ctc_loss, torch.cat([m.greedy_ids] * 2))
            return fn
        return make

    stack.enter_context(_patched(step, "_grad_and_metrics", grad_and_metrics))
    stack.enter_context(_patched(step, "_eval_fn", eval_fn))
    return stack


def altered_token():
    from paa_tpu_torch.ops import ctc

    def greedy_ids(_original):
        def fn(logits):
            ids = torch.argmax(logits, dim=-1)
            ids[:, ::10] = torch.argmin(logits[:, ::10], dim=-1)
            return ids.to(torch.int32)
        return fn

    return _patched(ctc, "greedy_ids", greedy_ids)


def k3_norm_high():
    from paa_tpu_torch.ops.kernels import fm_norm

    return _patched(fm_norm, "fm_weighted_norm", lambda f: lambda *a: 1.1 * f(*a))


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_token": altered_token, "k3_norm_high": k3_norm_high}
