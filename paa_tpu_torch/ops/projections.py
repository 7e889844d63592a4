"""The eight feasibility projections, in torch.

Port of ``paa_tpu/ops/projections.py``: ``perturbation_constraint`` maps a
perturbation back into the set chosen by ``AttackConfig.norm_type``. The
Fletcher-Munson norm goes through kernel K3 (``ops/kernels/fm_norm.py``) on
a CUDA tensor. Projections are never differentiated.
"""

from __future__ import annotations

import torch

from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.ops import dsp, psycho
from paa_tpu_torch.ops.kernels import fm_norm
from paa_tpu_torch.ops.psycho import PsychoTables

_EPS_NORM = 1e-8


def _scale_into_ball(x: torch.Tensor, norm: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Rescale ``x`` so its ``norm`` is at most ``radius`` (no-op inside)."""
    factor = torch.where(norm > radius, radius / torch.clamp(norm, min=_EPS_NORM),
                         torch.ones_like(norm))
    return x * factor


def project_l2(p: torch.Tensor, epsilon: torch.Tensor) -> torch.Tensor:
    return _scale_into_ball(p, torch.linalg.vector_norm(p), epsilon)


def project_l1(p: torch.Tensor, epsilon: torch.Tensor) -> torch.Tensor:
    """Radial scaling into the L1 ball, as the reference does."""
    return _scale_into_ball(p, torch.sum(torch.abs(p)), epsilon)


def project_linf(p: torch.Tensor, epsilon: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, -epsilon, epsilon)


def project_snr(p: torch.Tensor, clean: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
    """Rescale ``p`` so SNR(clean, p) reaches ``snr_db`` when below it.

    The target norm uses *clean's* element count (B·T) against the norm of
    the universal ``(1, T)`` perturbation, as the reference does."""
    signal_power = torch.mean(clean**2)
    noise_power = torch.mean(p**2)
    current_snr_db = 10.0 * torch.log10(signal_power / (noise_power + 1e-12))
    snr_linear = 10.0 ** (snr_db / 10.0)
    target_norm = torch.sqrt(signal_power / snr_linear * clean.numel())
    current_norm = torch.linalg.vector_norm(p)
    needs_scaling = (current_snr_db < snr_db) & (current_norm >= _EPS_NORM)
    factor = torch.where(needs_scaling, target_norm / torch.clamp(current_norm, min=_EPS_NORM),
                         torch.ones_like(current_norm))
    return p * factor


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic 1-D total variation summed over the batch."""
    return torch.sum(torch.abs(x[..., 1:] - x[..., :-1]))


def project_tv(p: torch.Tensor, clean: torch.Tensor, tv_epsilon: torch.Tensor) -> torch.Tensor:
    """Scale ``p`` so TV(p) ≤ tv_epsilon · TV(current clean batch)."""
    return _scale_into_ball(p, total_variation(p), tv_epsilon * total_variation(clean))


def project_min_max_freqs(stft_p, bin_freqs, min_freq, max_freq) -> torch.Tensor:
    """Zero the STFT bins *inside* [min_freq, max_freq]; keep the rest."""
    keep = (bin_freqs < min_freq) | (bin_freqs > max_freq)
    return stft_p * keep.to(torch.float32)[:, None]


def project_fm_norm(stft_p: torch.Tensor, tables: PsychoTables, fm_epsilon) -> torch.Tensor:
    """Scale STFT(p) into the Fletcher-Munson weighted-norm ball (K3)."""
    return _scale_into_ball(stft_p, fm_norm.fm_weighted_norm(stft_p, tables), fm_epsilon)


def project_phon_level(stft_p, spl_thresh, phon_reference_db: float) -> torch.Tensor:
    """Clip STFT magnitudes (dB) to the scaled ISO-226 contour, keeping phase:
    a magnitude *ratio* multiply, exactly zero-preserving."""
    mag_db = 20.0 * torch.log10(torch.abs(stft_p) + 1e-8)
    scaled_thresh = spl_thresh - torch.max(spl_thresh) + phon_reference_db
    clipped_db = torch.minimum(mag_db, scaled_thresh[:, None])
    return stft_p * 10.0 ** ((clipped_db - mag_db) / 20.0)


def project_frequency_domain(p, cfg: AttackConfig, params: ConstraintParams,
                             tables: PsychoTables) -> torch.Tensor:
    """STFT → project → iSTFT of exactly the input length."""
    T = p.shape[-1]
    stft_p = dsp.stft(p, cfg.n_fft, cfg.hop_length, cfg.win_length)
    if cfg.norm_type == "min_max_freqs":
        stft_p = project_min_max_freqs(stft_p, tables.bin_freqs, params.min_freq, params.max_freq)
    elif cfg.norm_type == "fletcher_munson":
        stft_p = project_fm_norm(stft_p, tables, params.fm_epsilon)
    elif cfg.norm_type == "max_phon":
        contour = psycho.phon_contour(tables, params.max_phon_level)
        stft_p = project_phon_level(stft_p, contour, cfg.phon_reference_db)
    else:
        raise ValueError(f"Unsupported frequency-domain norm_type: {cfg.norm_type!r}")
    return dsp.istft(stft_p, cfg.n_fft, cfg.hop_length, cfg.win_length, length=T)


def perturbation_constraint(p, clean, cfg: AttackConfig, params: ConstraintParams,
                            tables: PsychoTables) -> torch.Tensor:
    """Project ``p`` into the feasible set selected by ``cfg.norm_type``."""
    if cfg.is_freq_domain:
        return project_frequency_domain(p, cfg, params, tables)
    if cfg.norm_type == "l2":
        return project_l2(p, params.l2_size)
    if cfg.norm_type == "l1":
        return project_l1(p, params.l1_size)
    if cfg.norm_type == "linf":
        return project_linf(p, params.linf_size)
    if cfg.norm_type == "snr":
        if clean is None:
            raise ValueError("SNR projection requires clean_audio to compare to")
        return project_snr(p, clean, params.snr_db)
    if cfg.norm_type == "tv":
        if clean is None:
            raise ValueError("TV projection requires clean_audio for its budget")
        return project_tv(p, clean, params.tv_epsilon)
    raise ValueError(f"Unknown norm_type: {cfg.norm_type!r}")
