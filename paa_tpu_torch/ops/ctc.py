"""CTC loss and greedy decode, in torch.

Port of ``paa_tpu/ops/ctc.py``. The loss is ``F.ctc_loss`` over a float32
log-softmax with blank = ``PAD_ID`` and the reference's reductions.

One difference needs care: for a label sequence no alignment can emit in
the available frames (more labels plus repeats than frames), optax returns a
large finite loss (its ``log_epsilon = -1e5`` stands in for log 0), where
``F.ctc_loss`` returns ``inf``. Those rows are recomputed here with optax's
own forward recursion, so the port returns optax's value and a finite
gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paa_tpu_torch.ops.text import PAD_ID

_LOG_EPSILON = -1e5  # optax.ctc_loss's default stand-in for log(0)


def _label_lengths(label_paddings: torch.Tensor) -> torch.Tensor:
    return (label_paddings.shape[1] - label_paddings.sum(dim=1)).round().long()


def _infeasible(labels: torch.Tensor, lengths: torch.Tensor, frames: int) -> torch.Tensor:
    """Rows whose labels need more frames than there are: one per label plus
    one blank between each pair of equal neighbours."""
    pos = torch.arange(labels.shape[1] - 1, device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1]) & (pos[None, :] + 1 < lengths[:, None])).sum(1)
    return lengths + repeats > frames


def _optax_ctc(logprobs: torch.Tensor, labels: torch.Tensor,
               label_paddings: torch.Tensor) -> torch.Tensor:
    """Per-example loss by optax's recursion (``optax.ctc_loss_with_forward_probs``,
    no logit padding). ``logprobs``: (B, T, K) float32 log-softmax."""
    B, T, _ = logprobs.shape
    N = labels.shape[1]
    eps = _LOG_EPSILON
    repeat = torch.zeros((B, N), dtype=torch.float32, device=logprobs.device)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    lp_phi = logprobs[:, :, PAD_ID]  # (B, T)
    lp_emit = torch.gather(logprobs, 2, labels.long()[:, None, :].expand(B, T, N))  # (B, T, N)

    def add_phi(phi, score):  # logaddexp into phi[:, 1:]
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=1)

    phi = torch.full((B, N + 1), eps, device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), eps, device=logprobs.device)
    for t in range(T):
        prev_phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[:, t], emit + lp_emit[:, t])
        next_phi = prev_phi + lp_phi[:, t : t + 1]
        next_phi = add_phi(next_phi, emit + lp_phi[:, t : t + 1] + eps * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, _label_lengths(label_paddings)[:, None])[:, 0]


def ctc_loss(
    logits: torch.Tensor,  # (B, T, V)
    labels: torch.Tensor,  # (B, L) integer, PAD_ID at padded positions
    label_paddings: torch.Tensor,  # (B, L) float, 1.0 where padded
    reduction: str = "sum",
) -> torch.Tensor:
    """CTC negative log likelihood with the reference's reductions."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"Unknown reduction {reduction!r}")
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    B, T, _ = logprobs.shape
    lengths = _label_lengths(label_paddings)
    per_example = F.ctc_loss(
        logprobs.transpose(0, 1),
        labels.long(),
        torch.full((B,), T, dtype=torch.long, device=logits.device),
        lengths,
        blank=PAD_ID,
        reduction="none",
        zero_infinity=True,
    )
    bad = _infeasible(labels, lengths, T)
    if bool(bad.any()):  # waits for the device once per call
        rows = bad.nonzero()[:, 0]
        fixed = _optax_ctc(logprobs[rows], labels[rows], label_paddings[rows])
        per_example = per_example.index_put((rows,), fixed)
    if reduction == "sum":
        return per_example.sum()
    if reduction == "mean":
        return (per_example / torch.clamp(lengths.float(), min=1.0)).mean()
    return per_example


def greedy_ids(logits: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax ids ``(B, T)`` int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def collapse_mask(ids: torch.Tensor) -> torch.Tensor:
    """True at frames that survive the CTC collapse (first of a run, not blank)."""
    prev = F.pad(ids[..., :-1], (1, 0), value=-1)
    return (ids != prev) & (ids != PAD_ID)
