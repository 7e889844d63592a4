"""Psychoacoustic tables and the Fletcher-Munson weighting, in torch.

Port of ``paa_tpu/ops/psycho.py``. The tables are built once from the
numpy ``paa_tpu.ops.iso226`` grids at the run's STFT bin frequencies; the
per-cell weight is a lerp along the phon axis. ``fm_weighted_norm`` here is
the reference semantics that kernel K3 (``ops/kernels/fm_norm.py``) is held
against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from paa_tpu.ops import iso226
from paa_tpu_torch.config import AttackConfig
from paa_tpu_torch.ops import dsp


class PsychoTables(NamedTuple):
    fm_table: torch.Tensor  # (10, F) FM penalty weights per (phon level, bin)
    fm_in_domain: torch.Tensor  # (F,) 1.0 where the bin lies in [20, 20000] Hz
    phon_table: torch.Tensor  # (91, F) ISO-226 SPL per (integer phon, bin)
    bin_freqs: torch.Tensor  # (F,) rFFT bin frequencies in Hz


def build_tables(cfg: AttackConfig, device=None) -> PsychoTables:
    bin_freqs = dsp.rfft_bin_freqs(cfg.n_fft, cfg.sr)
    fm_table, fm_in_domain = iso226.fm_weight_table(bin_freqs)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    return PsychoTables(
        fm_table=f32(fm_table),
        fm_in_domain=f32(fm_in_domain),
        phon_table=f32(iso226.phon_threshold_table(bin_freqs)),
        bin_freqs=f32(bin_freqs),
    )


def phon_contour(tables: PsychoTables, phon: torch.Tensor) -> torch.Tensor:
    """ISO-226 SPL contour ``(F,)`` at a (possibly fractional) phon level."""
    pos = torch.clamp(torch.as_tensor(phon, dtype=torch.float32), 0.0, 90.0)
    i0 = torch.clamp(torch.floor(pos), 0.0, 89.0)
    frac = pos - i0
    i0 = i0.long()
    return tables.phon_table[i0] * (1.0 - frac) + tables.phon_table[i0 + 1] * frac


def fm_cell_weights(power: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """Perceptual weight in [0, 1] of each ``(..., F, T)`` STFT cell.

    SPL ``10·log10(power + 1e-10)`` is the phon coordinate; cells whose SPL
    lies outside [0, 90] or whose bin lies outside [20, 20000] Hz get the
    fill value 1.0.
    """
    spl = 10.0 * torch.log10(power + 1e-10)
    pos = spl / 10.0
    i0 = torch.clamp(torch.floor(pos), 0, 8)
    frac = torch.clamp(pos - i0, 0.0, 1.0)
    i0 = i0.long()
    f_idx = torch.arange(power.shape[-2], device=power.device)[:, None].expand(power.shape)
    w = tables.fm_table[i0, f_idx] * (1.0 - frac) + tables.fm_table[i0 + 1, f_idx] * frac
    in_phon = (spl >= 0.0) & (spl <= 90.0)
    in_freq = tables.fm_in_domain[:, None] > 0.5
    return torch.where(in_phon & in_freq, w, torch.ones_like(w))


def fm_weighted_norm(stft_p: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """``sqrt(Σ w·|X|²)`` over all cells."""
    power = torch.abs(stft_p) ** 2
    return torch.sqrt(torch.sum(fm_cell_weights(power, tables) * power))
