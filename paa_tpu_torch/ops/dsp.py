"""STFT / iSTFT with the conventions of ``paa_tpu/ops/dsp.py``.

``torch.stft(center=True)``: reflect padding of ``n_fft // 2`` on both
sides, ``1 + T // hop`` frames, a periodic Hann window of ``win_length``
(zero-padded and centred to ``n_fft``), no normalisation. The iSTFT takes an
explicit ``length`` so that a round trip returns exactly ``T`` samples.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, float32."""
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32, device=device)


def num_frames(length: int, n_fft: int, hop_length: int) -> int:
    """Frames of a centred transform: ``1 + (T + 2·(n_fft//2) − n_fft) // hop``."""
    return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop_length


def stft(
    x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024
) -> torch.Tensor:
    """``(..., T)`` real → ``(..., F, frames)`` complex64, ``F = n_fft // 2 + 1``."""
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]),
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=hann_window(win_length, x.device),
        center=True,
        pad_mode="reflect",
        normalized=False,
        onesided=True,
        return_complex=True,
    )
    return spec.reshape(lead + spec.shape[-2:])


def istft(
    spec: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    length: int | None = None,
) -> torch.Tensor:
    """``(..., F, frames)`` complex → ``(..., length)`` real; the default
    length is ``hop_length · (frames − 1)``, as ``torch.istft``'s."""
    frames = spec.shape[-1]
    out_len = hop_length * (frames - 1) if length is None else length
    lead = spec.shape[:-2]
    y = torch.istft(
        spec.reshape((-1,) + spec.shape[-2:]),
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=hann_window(win_length, spec.device),
        center=True,
        normalized=False,
        onesided=True,
        length=out_len,
    )
    return y.reshape(lead + (out_len,))


def align_to(target_len: int, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad or crop the last dim of ``x`` to ``target_len``."""
    cur = x.shape[-1]
    if cur >= target_len:
        return x[..., :target_len]
    return torch.nn.functional.pad(x, (0, target_len - cur))


def rfft_bin_freqs(n_fft: int, sr: int) -> np.ndarray:
    """Frequencies (Hz) of the rFFT bins — numpy, for table precompute."""
    return np.fft.rfftfreq(n_fft, d=1.0 / sr)
