"""The plain attack around a family's plain model: the CTC loss of a batch
and its gradient with respect to the universal perturbation ``p``, the PGD
sign step and the Fletcher-Munson projection, all in float32.

A batch runs in blocks of rows so that it fits the card: each block's loss
is summed and its gradient is accumulated into one ``p``. The projection
takes ``p`` ``(1, T)`` to the centred STFT (periodic Hann window), weights
each cell's power by the ISO 226 table of :mod:`.iso226` (the cell's SPL
``10·log10(power + 1e-10)`` as the phon coordinate, linear between the
table's levels, weight 1 outside [0, 90] phon or [20, 20000] Hz), scales
the STFT into the ball of radius ``epsilon`` under ``sqrt(Σ w·power)`` and
resynthesises ``T`` samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import iso226


class Geometry(NamedTuple):
    sample_rate: int
    n_fft: int
    hop: int
    win: int


class Tables(NamedTuple):
    weight: torch.Tensor  # (10, F)
    in_domain: torch.Tensor  # (F,)


def tables(geom: Geometry, device) -> Tables:
    bins = np.fft.rfftfreq(geom.n_fft, d=1.0 / geom.sample_rate)
    table, dom = iso226.fm_table(bins)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return Tables(f32(table), f32(dom))


def _window(geom: Geometry, device) -> torch.Tensor:
    return torch.hann_window(geom.win, periodic=True, dtype=torch.float32, device=device)


def fm_norm(spec: torch.Tensor, tab: Tables) -> torch.Tensor:
    """``sqrt(Σ w·|X|²)`` of an STFT ``(..., F, frames)``."""
    power = spec.real ** 2 + spec.imag ** 2
    level = 10.0 * torch.log10(power + 1e-10)
    i0 = torch.clamp(torch.floor(level / 10.0), 0, 8)
    frac = torch.clamp(level / 10.0 - i0, 0.0, 1.0)
    i0 = i0.long()
    f = torch.arange(power.shape[-2], device=power.device)[:, None].expand(power.shape)
    w = tab.weight[i0, f] * (1.0 - frac) + tab.weight[i0 + 1, f] * frac
    inside = (level >= 0.0) & (level <= 90.0) & (tab.in_domain[:, None] > 0.5)
    w = torch.where(inside, w, torch.ones_like(w))
    return torch.sqrt(torch.sum(w * power))


def project(p: torch.Tensor, epsilon: float, geom: Geometry, tab: Tables) -> torch.Tensor:
    """``p`` ``(1, T)`` scaled into the Fletcher-Munson ball in the STFT
    domain and resynthesised to ``T`` samples."""
    T = p.shape[-1]
    win = _window(geom, p.device)
    spec = torch.stft(p, geom.n_fft, geom.hop, geom.win, window=win, center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    norm = fm_norm(spec, tab)
    if float(norm) > epsilon:
        spec = spec * (epsilon / float(norm))
    return torch.istft(spec, geom.n_fft, geom.hop, geom.win, window=win, center=True,
                       normalized=False, onesided=True, length=T)


def initial_p(seed: int, samples: int, epsilon: float, geom: Geometry, tab: Tables,
              device) -> torch.Tensor:
    """The attack's start: N(0, 1) samples from a CPU generator seeded with
    ``seed``, projected once."""
    raw = torch.randn((1, samples), generator=torch.Generator().manual_seed(seed))
    return project(raw.to(device), epsilon, geom, tab)


def sign_step(p: torch.Tensor, grad: torch.Tensor, lr: float) -> torch.Tensor:
    """PGD's ascent step on the CTC loss (the attack is untargeted)."""
    return p + lr * torch.sign(grad)


class BatchResult(NamedTuple):
    loss: float  # Σ over rows of weight · CTC
    grad: torch.Tensor | None  # ∂loss/∂p (1, T), or None without grad
    logit_gap: float  # the widest gap of the given ids below the best logit
    ids: torch.Tensor  # (B, frames) int32, the reference's own greedy ids


def run_batch(model, params: dict, cfg: dict, audio: torch.Tensor, labels: torch.Tensor,
              lengths: torch.Tensor, weights: torch.Tensor, p: torch.Tensor,
              ids: torch.Tensor | None, rows: int, grad: bool, clamp: bool,
              prec=None) -> BatchResult:
    """Through ``model``, the family's plain reference
    (``reference/<family>.py``, with ``prec`` one of its ``Precision``s):
    the loss of ``audio + p`` (clamped to [-1, 1] with ``clamp``), its
    gradient with respect to ``p`` when ``grad``, the reference's greedy
    ids, and the widest gap by which the logit of ``ids`` ``(B, frames)``
    lies below the row and frame's best over the rows of weight > 0 (0
    without ``ids``), in blocks of ``rows`` rows."""
    p_leaf = p.detach().clone().requires_grad_(grad)
    loss, gap, own = 0.0, 0.0, []
    for start in range(0, audio.shape[0], rows):
        block = slice(start, start + rows)
        with torch.set_grad_enabled(grad):
            x = audio[block] + p_leaf
            if clamp:
                x = torch.clamp(x, -1.0, 1.0)
            logits = model.forward(params, cfg, x, prec)
            per_row = model.ctc_losses(logits, labels[block], lengths[block])
            block_loss = torch.sum(per_row * weights[block])
            if grad:
                block_loss.backward()
        with torch.no_grad():
            lg = logits.detach()
            own.append(lg.argmax(-1).to(torch.int32))
            live = weights[block] > 0
            if ids is not None and bool(live.any()):
                chosen = torch.gather(lg, 2, ids[block].long()[..., None])[..., 0]
                rows_gap = (lg.amax(-1) - chosen).amax(-1)
                gap = max(gap, float(rows_gap[live].max()))
        loss += float(block_loss.detach())
        del logits, per_row, block_loss, x
    return BatchResult(loss, p_leaf.grad if grad else None, gap, torch.cat(own))
