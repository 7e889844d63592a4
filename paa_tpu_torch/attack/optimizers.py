"""Perturbation optimizers: PGD sign steps and Adam, plus the StepLR decay.

Port of ``paa_tpu/attack/optimizers.py``:
  * PGD:  ``p ← p + lr·direction·sign(∂loss/∂p)``;
  * Adam: descent on ``−direction·loss`` with ``optax.scale_by_adam(0.9,
    0.999, 1e-8)`` semantics, bias correction included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from paa_tpu_torch.config import AttackConfig

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """``optax.ScaleByAdamState``: step count and the two moments."""

    count: torch.Tensor  # int32 scalar
    mu: torch.Tensor
    nu: torch.Tensor


def init_opt_state(cfg: AttackConfig, p: torch.Tensor) -> AdamState | None:
    """Adam state for the perturbation; PGD is stateless (``None``)."""
    if cfg.optimizer_type == "adam":
        zeros = torch.zeros_like(p)
        return AdamState(torch.zeros((), dtype=torch.int32, device=p.device), zeros, zeros.clone())
    return None


def apply_update(
    cfg: AttackConfig,
    p: torch.Tensor,
    grad: torch.Tensor,  # ∂loss/∂p of the raw CTC loss
    opt_state: AdamState | None,
    lr,
) -> tuple[torch.Tensor, AdamState | None]:
    """One optimizer update of the perturbation (projection not included)."""
    direction = cfg.loss_direction
    if cfg.optimizer_type == "pgd":
        return p + lr * direction * torch.sign(grad), opt_state
    if cfg.optimizer_type == "adam":
        g = -direction * grad
        mu = _B1 * opt_state.mu + (1.0 - _B1) * g
        nu = _B2 * opt_state.nu + (1.0 - _B2) * g * g
        count = opt_state.count + 1
        mu_hat = mu / (1.0 - _B1 ** count.float())
        nu_hat = nu / (1.0 - _B2 ** count.float())
        updates = mu_hat / (torch.sqrt(nu_hat) + _EPS)
        return p - lr * updates, AdamState(count, mu, nu)
    raise NotImplementedError(f"Optimization type not implemented: {cfg.optimizer_type!r}")


def step_lr(cfg: AttackConfig, epoch: int) -> float:
    """StepLR: ``lr·gamma^(epoch // step_size)``, stepped per epoch."""
    return cfg.lr * cfg.gamma ** (epoch // cfg.step_size)
