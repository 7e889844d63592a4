"""ISO-226 equal-loudness contours and perceptual weight tables (host side).

Implements the ISO 226 closed-form approximation over the standard 29
third-octave bands, matching the reference's model (reference:
src/core/iso.py:34-266) including its quirks:

  * tables extended to 20 kHz by appending the **20 Hz** entry (a
    wrap-around boundary the reference explicitly keeps — iso.py:104-124),
  * monotone PCHIP interpolation of alpha / L_u / T_f across frequency,
  * perceptual penalty weight ``(1 - SPL/SPL_max)^2`` clipped to [0, 1]
    (iso.py:202-235),
  * a (phon 0..90 step 10) × (freq) weight grid wrapped in a bilinear
    interpolator with fill value 1.0 outside the domain (iso.py:238-266).

TPU-first design: everything here runs ONCE on the host at setup time
(numpy/scipy, microseconds of work), producing dense ``float32`` tables
aligned to the run's STFT bin frequencies. The hot loop then never leaves
the device: the Fletcher-Munson weighted norm becomes a pure gather +
lerp + multiply (see ops/psycho.py), eliminating the reference's
per-batch device→host→device round-trip (reference: src/core/
projections.py:104-109, its #1 hot-loop bottleneck).

Because the reference's ``RegularGridInterpolator`` is *separable*
bilinear interpolation, pre-evaluating the frequency axis at the fixed
STFT bin frequencies and leaving only the phon axis for the device is
numerically identical to the reference's 2-D query.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import PchipInterpolator

# ISO 226 tabulated parameters at 29 third-octave center frequencies.
# (Public standard constants; reference copy at src/core/iso.py:60-84.)
ISO226_FREQUENCIES = np.array([
    20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0, 200.0,
    250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0,
    2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0,
    12500.0,
])
ISO226_ALPHA = np.array([
    0.532, 0.506, 0.480, 0.455, 0.432, 0.409, 0.387, 0.367, 0.349, 0.330,
    0.315, 0.301, 0.288, 0.276, 0.267, 0.259, 0.253, 0.250, 0.246, 0.244,
    0.243, 0.243, 0.243, 0.242, 0.242, 0.245, 0.254, 0.271, 0.301,
])
ISO226_LU = np.array([
    -31.6, -27.2, -23.0, -19.1, -15.9, -13.0, -10.3, -8.1, -6.2, -4.5,
    -3.1, -2.0, -1.1, -0.4, 0.0, 0.3, 0.5, 0.0, -2.7, -4.1, -1.0, 1.7,
    2.5, 1.2, -2.1, -7.1, -11.2, -10.7, -3.1,
])
ISO226_TF = np.array([
    78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4,
    11.4, 8.6, 6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0, -5.4,
    -1.5, 6.0, 12.6, 13.9, 12.3,
])

FREQ_MIN_HZ = 20.0
FREQ_MAX_HZ = 20000.0
PHON_MIN = 0.0
PHON_MAX = 90.0

# Extended frequency grid: append 20 kHz; parameter value wraps to the
# 20 Hz entry, preserving the reference's constant-end boundary choice
# (reference: src/core/iso.py:104-124).
_F_EXT = np.concatenate([ISO226_FREQUENCIES, [FREQ_MAX_HZ]])
_ALPHA_EXT = np.concatenate([ISO226_ALPHA, [ISO226_ALPHA[0]]])
_LU_EXT = np.concatenate([ISO226_LU, [ISO226_LU[0]]])
_TF_EXT = np.concatenate([ISO226_TF, [ISO226_TF[0]]])

_alpha_interp = PchipInterpolator(_F_EXT, _ALPHA_EXT)
_lu_interp = PchipInterpolator(_F_EXT, _LU_EXT)
_tf_interp = PchipInterpolator(_F_EXT, _TF_EXT)


def iso226_spl(phon: float, frequencies) -> np.ndarray:
    """SPL (dB) needed at each frequency to be perceived at ``phon`` loudness.

    Vectorized ISO-226 closed form (reference: src/core/iso.py:126-173,
    formula at :163-171, here evaluated on whole arrays at once).
    """
    if phon < PHON_MIN or phon > PHON_MAX:
        raise ValueError("Phon must be in range [0, 90]")
    f = np.asarray(frequencies, dtype=np.float64)
    if np.any(f < FREQ_MIN_HZ) or np.any(f > FREQ_MAX_HZ):
        raise ValueError("Frequency must be in [20, 20000] Hz")
    alpha = _alpha_interp(f)
    lu = _lu_interp(f)
    tf = _tf_interp(f)
    a = 0.00447 * (10.0 ** (0.025 * phon) - 1.15)
    b = (0.4 * 10.0 ** ((tf + lu) / 10.0 - 9.0)) ** alpha
    return (10.0 / alpha) * np.log10(a + b) - lu + 94.0


def compute_weight_matrix():
    """(freqs, phons, spl_matrix) grid over phon 0..90 × ISO freqs + 20 kHz.

    Reference: src/core/iso.py:176-199.
    """
    phons = np.arange(0, 100, 10).astype(np.float64)
    freqs = _F_EXT.copy()
    spl_matrix = np.stack([iso226_spl(p, freqs) for p in phons])
    return freqs, phons, spl_matrix


def perceptual_weight(spl_matrix: np.ndarray) -> np.ndarray:
    """Map an SPL grid to penalty weights ``(1 - spl/spl_max)^2`` in [0, 1].

    Reference: src/core/iso.py:202-235.
    """
    max_spl = spl_matrix.max()
    weights = (1.0 - spl_matrix / max_spl) ** 2
    return np.clip(weights, 0.0, 1.0)


def fm_weight_table(bin_freqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Perceptual weight table pre-evaluated at fixed STFT bin frequencies.

    Returns:
      table: ``(P=10, F)`` float32 — penalty weight at (phon level p,
        bin f), linearly interpolated along frequency exactly as the
        reference's ``RegularGridInterpolator`` would (it is separable
        bilinear, so fixing the frequency coordinate here and lerping the
        phon coordinate on device reproduces its 2-D queries bit-for-bit
        for on-bin frequencies).
      in_domain: ``(F,)`` float32 mask — 1.0 where the bin frequency lies
        inside [20, 20000] Hz; outside, the reference interpolator
        returns its fill value 1.0 regardless of phon
        (reference: src/core/iso.py:249-266).
    """
    freqs, phons, spl_matrix = compute_weight_matrix()
    weights = perceptual_weight(spl_matrix)  # (P, 30)

    bin_freqs = np.asarray(bin_freqs, dtype=np.float64)
    in_domain = (bin_freqs >= FREQ_MIN_HZ) & (bin_freqs <= FREQ_MAX_HZ)

    # Linear interpolation along the frequency axis at each bin.
    f_clamped = np.clip(bin_freqs, freqs[0], freqs[-1])
    hi = np.searchsorted(freqs, f_clamped, side="left")
    hi = np.clip(hi, 1, len(freqs) - 1)
    lo = hi - 1
    t = (f_clamped - freqs[lo]) / (freqs[hi] - freqs[lo])
    table = weights[:, lo] * (1.0 - t) + weights[:, hi] * t  # (P, F)

    return table.astype(np.float32), in_domain.astype(np.float32)


def phon_threshold(bin_freqs: np.ndarray, phon: float) -> np.ndarray:
    """Per-bin SPL threshold (dB) of the ``phon`` equal-loudness contour.

    Bin frequencies outside [20, 20000] Hz are clamped first, so the DC
    bin reuses the 20 Hz value (reference: src/training_utils/
    build.py:325-348). Returns ``(F,)`` float32.
    """
    f = np.clip(np.asarray(bin_freqs, dtype=np.float64), FREQ_MIN_HZ, FREQ_MAX_HZ)
    return iso226_spl(float(phon), f).astype(np.float32)


def phon_threshold_table(bin_freqs: np.ndarray) -> np.ndarray:
    """Thresholds for every integer phon level 0..90 → ``(91, F)``.

    Device-side code lerps along the phon axis to support a *traced*
    (sweepable) ``max_phon_level`` without rebuilding tables — the
    TPU-native replacement for the reference's per-run threshold tensor
    (reference: src/training_utils/build.py:325-348). Step-1 granularity
    makes the lerp EXACT at every integer phon level (the reference's
    sweep grid is 15/20/25/30/35, submit_scan_range.py:88); between
    integers the ISO-226 closed form is smooth enough that linear
    interpolation error is far below the projection's own dB tolerance.
    """
    return np.stack(
        [phon_threshold(bin_freqs, p) for p in range(0, 91)]
    ).astype(np.float32)
